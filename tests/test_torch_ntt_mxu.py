"""The port's four-step int8 NTT (gemini_seal_tpu_torch.ops.ntt_mxu) and
mul_mod_shoup against the JAX package.

The JAX functions run on numpy inputs (their host branch, np.einsum), so
nothing is compiled.  Tables equal field by field for the moduli of
tools/bench_ntt_mxu.py's two shapes, built at N=1024 with the same bit
sizes; the digit split exact on 56-bit values; mul_mod_shoup at its boundary
values; the forward and inverse transforms (the plain versions, the CPU path
of kernel ``ntt_mxu``) equal bit for bit to the JAX transforms and to the
port's radix-2 NTT at the JAX tests' rings, on lazy [0, 2p) inputs; and the
builder's rejection of an oversized modulus with the JAX text.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gemini_seal_tpu.modulus import CoeffModulus, Modulus
from gemini_seal_tpu.ops import modops as jmod
from gemini_seal_tpu.ops import ntt_mxu as jmx
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import modops as tmod
from gemini_seal_tpu_torch.ops import ntt as tn
from gemini_seal_tpu_torch.ops import ntt_mxu as tmx
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

# tools/bench_ntt_mxu.py's moduli: config 4's ring and the headline ring
TOOL_BITS = {"n16384": [50, 40, 40, 40, 40, 50], "n8192": [50, 40, 40, 50]}


def _host(t):
    return t.numpy() if t.dtype == torch.int8 else to_numpy(t)


@pytest.mark.parametrize("shape", sorted(TOOL_BITS))
def test_tables_equal(shape):
    mods = CoeffModulus.create(1024, TOOL_BITS[shape])
    j = jmx.build_mxu_ntt_tables(10, mods)
    t = tmx.build_mxu_ntt_tables(10, [m.value for m in mods], device="cpu")
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            b = _host(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_digit_split_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 56, 100, dtype=np.uint64)
    x[:3] = [0, (1 << 56) - 1, 0x8080808080808]
    want = jmx._balanced_digits_dev(x, 8, np)
    got = tmx._balanced_digits_dev(to_tensor(x, "cpu"), 8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.zeros(100, dtype=object)
    for d in range(8):
        back += got.numpy()[d].astype(object) * (256 ** d)
    assert all(int(b) == int(v) for b, v in zip(back, x))


@pytest.mark.parametrize("bits", [50, 60])
def test_mul_mod_shoup_boundaries(bits):
    p = get_primes(1024, bits, 1)[0]
    xs = np.array([0, 1, p - 1, p, 2 * p - 1, (1 << 64) - 1], dtype=np.uint64)
    ws = np.array([0, 1, 2, p - 2, p - 1, p // 3], dtype=np.uint64)
    x, w = (a.ravel() for a in np.meshgrid(xs, ws))
    ws_shoup = np.array([((int(v) << 64) // p) & ((1 << 64) - 1) for v in w], dtype=np.uint64)
    pv = np.full_like(x, p)
    want = jmod.mul_mod_shoup(x, w, ws_shoup, pv)
    got = tmod.mul_mod_shoup(*(to_tensor(a, "cpu") for a in (x, w, ws_shoup, pv)))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert (want < p).all()


@pytest.mark.parametrize("log_n,bits", [(4, [30, 30]), (6, [36, 36]), (8, [50, 50]),
                                        (10, [54, 54]), (10, [50, 40])])
def test_transforms_equal(log_n, bits):
    """Forward and inverse on lazy [0, 2p) inputs (2p - 1 and 0 included),
    a batch of three in front of the limb axis: equal to the JAX host
    transforms and to the port's radix-2 NTT (plain K1)."""
    n = 1 << log_n
    mods = CoeffModulus.create(max(n, 1024), bits)
    vals = [m.value for m in mods]
    j = jmx.build_mxu_ntt_tables(log_n, mods)
    t = tmx.build_mxu_ntt_tables(log_n, vals, device="cpu")
    k1 = tn.build_ntt_tables(log_n, vals).to("cpu")
    rng = np.random.default_rng(42 + log_n + bits[-1])
    x = np.stack([rng.integers(0, 2 * p, (3, n), dtype=np.uint64) for p in vals], axis=1)
    x[0, :, 0] = [2 * p - 1 for p in vals]
    x[1, :, -1] = 0
    xt = to_tensor(x, "cpu")
    with contiguous_calls():  # what the kernel demands of each pass's tensors
        fwd = tmx.ntt_forward_mxu(xt, t)
        inv = tmx.ntt_inverse_mxu(xt, t)
    np.testing.assert_array_equal(to_numpy(fwd), jmx.ntt_forward_mxu(x, j))
    np.testing.assert_array_equal(to_numpy(inv), jmx.ntt_inverse_mxu(x, j))
    assert torch.equal(fwd, tn.ntt_forward(xt, k1))
    assert torch.equal(inv, tn.ntt_inverse(xt, k1))
    canon = np.stack([x[:, li] % p for li, p in enumerate(vals)], axis=1)
    assert torch.equal(tmx.ntt_inverse_mxu(fwd, t), to_tensor(canon, "cpu"))


def test_pass_twist_epilogue_equal():
    """One pass with the twist epilogue (the kernel's first launch of each
    direction) against the JAX pass followed by its mul_mod_shoup, on a
    batch shape of five by three."""
    mods = CoeffModulus.create(1024, [50, 40])
    vals = [m.value for m in mods]
    j = jmx.build_mxu_ntt_tables(9, mods)
    t = tmx.build_mxu_ntt_tables(9, vals, device="cpu")
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(0, 2 * p, (5, 3, j.n1, j.n2), dtype=np.uint64) for p in vals],
                 axis=2)
    p3 = j.modulus[:, None, None]
    want = jmod.mul_mod_shoup(jmx._pass(x, j.fwd_col, j, "A", np), j.fwd_twist,
                              j.fwd_twist_shoup, p3)
    got = tmx.mxu_pass(to_tensor(x, "cpu"), t.fwd_col, t, "A",
                       twist=(t.fwd_twist, t.fwd_twist_shoup))
    np.testing.assert_array_equal(to_numpy(got), want)
    want_b = jmx._pass(x, j.inv_row, j, "B", np)
    got_b = tmx.mxu_pass(to_tensor(x, "cpu"), t.inv_row, t, "B")
    np.testing.assert_array_equal(to_numpy(got_b), want_b)


def test_oversized_modulus_rejected():
    big = (1 << 60) - (1 << 14) + 1
    with pytest.raises(ValueError) as jerr:
        jmx.build_mxu_ntt_tables(11, [Modulus(big)])
    with pytest.raises(ValueError) as terr:
        tmx.build_mxu_ntt_tables(11, [big], device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "128-bit MXU digit recombine" in str(terr.value)
