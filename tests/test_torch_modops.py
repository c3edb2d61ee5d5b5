"""The port's scalar layer (gemini_seal_tpu_torch.ops.modops, plain versions
on the int64 substrate) against the JAX package's modops under jax.jit.

Exact equality for every array; moduli of 40, 50 and 60 bits; edge values
0, p-1, 2p-1, 4p-1 and 2^64-1 wherever the function's input contract
admits them.
"""

import jax
import numpy as np
import pytest
import torch

from gemini_seal_tpu.modulus import Modulus as JModulus
from gemini_seal_tpu.ops import modops as jm
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import modops as tm
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

U64_MAX = (1 << 64) - 1
N = 512


def _prime(bits):
    p = get_primes(1024, bits, 1)[0]
    m = JModulus(p)
    return p, np.uint64(m.const_ratio[0]), np.uint64(m.const_ratio[1])


def _vals(rng, hi, edges):
    """[N] u64 values in [0, hi) with the edge values up front."""
    v = rng.integers(0, hi, size=N, dtype=np.uint64) if hi <= U64_MAX else \
        rng.integers(0, U64_MAX, size=N, dtype=np.uint64, endpoint=True)
    e = np.array(edges, dtype=np.uint64)
    v[: e.size] = e
    return v


def _t(a):
    return to_tensor(a, "cpu")


def _eq(jax_out, torch_out):
    if isinstance(jax_out, tuple):
        for j, t in zip(jax_out, torch_out):
            _eq(j, t)
        return
    np.testing.assert_array_equal(np.asarray(jax_out, dtype=np.uint64),
                                  to_numpy(torch_out).reshape(np.shape(jax_out)))


BITS = [40, 50, 60]


@pytest.mark.parametrize("bits", BITS)
def test_wide_products(bits):
    p, _, _ = _prime(bits)
    rng = np.random.default_rng(bits)
    edges = [0, p - 1, 2 * p - 1, 4 * p - 1, U64_MAX]
    a = _vals(rng, U64_MAX + 1, edges)
    b = _vals(rng, U64_MAX + 1, edges[::-1])
    _eq(jax.jit(jm.mul64_wide)(a, b), tm.mul64_wide(_t(a), _t(b)))
    _eq(jax.jit(jm.mulhi64)(a, b), tm.mulhi64(_t(a), _t(b)))


@pytest.mark.parametrize("bits", BITS)
def test_barrett_reductions(bits):
    p, r0, r1 = _prime(bits)
    rng = np.random.default_rng(100 + bits)
    hi = _vals(rng, p, [0, p - 1, p - 1, 0, 1])
    lo = _vals(rng, U64_MAX + 1, [0, U64_MAX, 0, U64_MAX, 4 * p - 1])
    P, R0, R1 = (np.full(N, v, dtype=np.uint64) for v in (p, r0, r1))
    _eq(jax.jit(jm.barrett_reduce_128)(hi, lo, P, R0, R1),
        tm.barrett_reduce_128(_t(hi), _t(lo), _t(P), _t(R0), _t(R1)))
    x = _vals(rng, 1 << 63, [0, p - 1, 2 * p - 1, 4 * p - 1, (1 << 63) - 1])
    _eq(jax.jit(jm.barrett_reduce_64)(x, P, R1),
        tm.barrett_reduce_64(_t(x), _t(P), _t(R1)))


@pytest.mark.parametrize("bits", BITS)
def test_mul_mod_and_shoup(bits):
    p, r0, r1 = _prime(bits)
    rng = np.random.default_rng(200 + bits)
    a = _vals(rng, p, [0, p - 1, p - 1, 1])
    b = _vals(rng, p, [p - 1, 0, p - 1, p - 1])
    P, R0, R1 = (np.full(N, v, dtype=np.uint64) for v in (p, r0, r1))
    _eq(jax.jit(jm.mul_mod)(a, b, P, R0, R1),
        tm.mul_mod(_t(a), _t(b), _t(P), _t(R0), _t(R1)))
    # Shoup: any 64-bit x, w < p
    x = _vals(rng, U64_MAX + 1, [0, p - 1, 2 * p - 1, 4 * p - 1, U64_MAX])
    w = b
    ws = np.array([((int(v) << 64) // p) & U64_MAX for v in w], dtype=np.uint64)
    _eq(jax.jit(jm.mul_mod_shoup_lazy)(x, w, ws, P),
        tm.mul_mod_shoup_lazy(_t(x), _t(w), _t(ws), _t(P)))


@pytest.mark.parametrize("bits", BITS)
def test_add_sub_neg_reduce(bits):
    p, _, _ = _prime(bits)
    rng = np.random.default_rng(300 + bits)
    a = _vals(rng, p, [0, p - 1, 0, p - 1])
    b = _vals(rng, p, [0, 0, p - 1, p - 1])
    P = np.full(N, p, dtype=np.uint64)
    _eq(jax.jit(jm.add_mod)(a, b, P), tm.add_mod(_t(a), _t(b), _t(P)))
    _eq(jax.jit(jm.sub_mod)(a, b, P), tm.sub_mod(_t(a), _t(b), _t(P)))
    _eq(jax.jit(jm.neg_mod)(a, P), tm.neg_mod(_t(a), _t(P)))
    x2 = _vals(rng, 2 * p, [0, p - 1, p, 2 * p - 1])
    _eq(jax.jit(jm.reduce_once)(x2, P), tm.reduce_once(_t(x2), _t(P)))
    x4 = _vals(rng, 4 * p, [0, p - 1, 2 * p - 1, 4 * p - 1])
    _eq(jax.jit(jm.reduce_twice)(x4, P), tm.reduce_twice(_t(x4), _t(P)))


@pytest.mark.parametrize("bits", BITS)
def test_accumulate_mulmod_128(bits):
    """The digit-plane accumulator, with lazy [0, 4p) operands and the
    all-ones worst case."""
    p, r0, r1 = _prime(bits)
    rng = np.random.default_rng(400 + bits)
    K = 6
    a = [_vals(rng, 4 * p, [4 * p - 1, 0, 2 * p - 1]) for _ in range(K)]
    b = [_vals(rng, p, [p - 1, p - 1, 0]) for _ in range(K)]

    def jfn(*ab):
        return jm.accumulate_mulmod_128(zip(ab[:K], ab[K:]), p, r0, r1)

    want = jax.jit(jfn)(*a, *b)
    P, R0, R1 = (torch.tensor([v], dtype=torch.int64) for v in
                 (np.int64(np.uint64(p).view(np.int64)), np.uint64(r0).view(np.int64),
                  np.uint64(r1).view(np.int64)))
    got = tm.accumulate_mulmod_128(zip(map(_t, a), map(_t, b)), P, R0, R1)
    _eq(want, got)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "muladd", "addmul", "barrett64"])
def test_elementwise_plain_matches_jax_chain(op):
    """Each op of the ``elementwise`` kernel's plain version against the JAX
    modops chain it replaces, with per-limb constants [L, 1]."""
    mods = [_prime(b) for b in BITS]
    rng = np.random.default_rng(500)
    L = len(mods)
    p = np.array([m[0] for m in mods], dtype=np.uint64).reshape(L, 1)
    r0 = np.array([m[1] for m in mods], dtype=np.uint64).reshape(L, 1)
    r1 = np.array([m[2] for m in mods], dtype=np.uint64).reshape(L, 1)
    a = np.stack([rng.integers(0, int(q), size=(3, N), dtype=np.uint64) for q in p[:, 0]], 1)
    b = np.stack([rng.integers(0, int(q), size=(3, N), dtype=np.uint64) for q in p[:, 0]], 1)
    s = np.array([rng.integers(0, int(q)) for q in p[:, 0]], dtype=np.uint64).reshape(L, 1)
    chains = {
        "add": lambda: jm.add_mod(a, b, p),
        "sub": lambda: jm.sub_mod(a, b, p),
        "neg": lambda: jm.neg_mod(a, p),
        "mul": lambda: jm.mul_mod(a, b, p, r0, r1),
        "muladd": lambda: jm.add_mod(b, jm.mul_mod(a, s, p, r0, r1), p),
        "addmul": lambda: jm.mul_mod(jm.add_mod(a, b, p), s, p, r0, r1),
        "barrett64": lambda: jm.barrett_reduce_64(a + s, p, r1),
    }
    want = jax.jit(chains[op])()
    bt = None if op == "neg" else (_t(s) if op == "barrett64" else _t(b))
    got = tm.rns_elementwise(op, _t(a), _t(p), _t(r0), _t(r1), b=bt, s=_t(s))
    _eq(want, got)
