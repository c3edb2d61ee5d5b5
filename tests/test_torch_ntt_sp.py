"""The port's coefficient-sharded NTT (gemini_seal_tpu_torch.parallel.ntt_sp,
with K1's sub_row mode and K11's exchange and rows modes in their plain
versions) against the JAX package, bit for bit: the hypercube and the
four-step forms at C in {2, 4, 8} against the JAX in-core transforms (jit),
the JAX schedules themselves on root conftest.py's virtual mesh at C = 4,
and the collective profile of each form; sub_row alone at N=65536 on two
chunks, where a chunk is above one block's shared memory.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal_tpu.ops import ntt as jn
from gemini_seal_tpu.parallel import ntt_sp as jsp
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import ntt as tn
from gemini_seal_tpu_torch.ops import ntt_sp as tk
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.parallel import ntt_sp as tsp
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

FORMS = {
    "hypercube": (tsp.ntt_forward_sharded, tsp.ntt_inverse_sharded),
    "4step": (tsp.ntt_forward_sharded_4step, tsp.ntt_inverse_sharded_4step),
}


def _tables(log_n, L, bits=50):
    primes = get_primes(2 << log_n, bits, L)
    return primes, jn.build_ntt_tables(log_n, primes), tn.build_ntt_tables(log_n, primes).to("cpu")


def _residues(rng, primes, lead, n, mult=1):
    return np.stack([rng.integers(0, mult * int(p), size=lead + (n,), dtype=np.uint64)
                     for p in primes], axis=len(lead))


def _run(fn, x, tables, C):
    n = x.shape[-1]
    chunks = [to_tensor(x[..., r * (n // C):(r + 1) * (n // C)], "cpu") for r in range(C)]
    team = ThreadGroup(C, "cpu")
    with contiguous_calls():
        outs = run_spmd(lambda g, xs: fn(xs, tables, g), team, chunks)
    return np.concatenate([to_numpy(o) for o in outs], axis=-1), team.stats


# the four-step form needs chunk >= C (JAX _check_4step): not at C=8, N=32
CASES = [(form, C, log_n) for form in FORMS for C, log_n in [(2, 5), (4, 8), (8, 5), (8, 8)]
         if form == "hypercube" or (1 << log_n) // C >= C]


@pytest.mark.parametrize("form,C,log_n", CASES)
def test_sharded_ntt_equals_jax_in_core(form, C, log_n):
    n = 1 << log_n
    primes, jt, tt = _tables(log_n, 3)
    rng = np.random.default_rng(C * 100 + log_n)
    x = _residues(rng, primes, (2,), n)
    fwd, inv = FORMS[form]
    got, stats = _run(fwd, x, tt, C)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda a: jn.ntt_forward(a, jt))(x)))
    kind = "collective-permute" if form == "hypercube" else "all-to-all"
    per_rank = {"collective-permute": C.bit_length() - 1, "all-to-all": 2}[kind]
    assert all(s.count == {kind: per_rank} for s in stats), stats
    assert stats[0].bytes[kind] == per_rank * x.nbytes // C
    got, _ = _run(inv, x, tt, C)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda a: jn.ntt_inverse(a, jt))(x)))


@pytest.mark.parametrize("form", list(FORMS))
def test_sharded_ntt_equals_jax_schedule(form):
    """The JAX schedules on the virtual mesh (jit), C = 4, N = 256."""
    C, log_n = 4, 8
    n = 1 << log_n
    primes, jt, tt = _tables(log_n, 2)
    x = _residues(np.random.default_rng(11), primes, (), n)
    mesh = Mesh(np.asarray(jax.devices()[:C]), axis_names=("coeff",))
    sh = NamedSharding(mesh, P(None, "coeff"))
    jf, ji = ((jsp.ntt_forward_sharded, jsp.ntt_inverse_sharded) if form == "hypercube" else
              (jsp.ntt_forward_sharded_4step, jsp.ntt_inverse_sharded_4step))
    fwd, inv = FORMS[form]
    want = np.asarray(jax.jit(lambda a: jf(a, jt, mesh))(jax.device_put(x, sh)))
    np.testing.assert_array_equal(_run(fwd, x, tt, C)[0], want)
    want = np.asarray(jax.jit(lambda a: ji(a, jt, mesh))(jax.device_put(x, sh)))
    np.testing.assert_array_equal(_run(inv, x, tt, C)[0], want)


def test_four_step_lazy_bodies_keep_the_lazy_contract():
    """forward_4step_local(lazy) is ntt_forward_lazy chunk for chunk, and
    inverse_4step_local(lazy) is ntt_inverse_lazy, on inputs over the whole
    lazy range ([0, 4p) forward, [0, 2p) inverse)."""
    C, log_n = 4, 6
    n = 1 << log_n
    primes, jt, tt = _tables(log_n, 2, bits=60)
    rng = np.random.default_rng(5)
    for mult, body, jfn in ((4, tsp.forward_4step_local, jn.ntt_forward_lazy),
                            (2, tsp.inverse_4step_local, jn.ntt_inverse_lazy)):
        x = _residues(rng, primes, (3,), n, mult)
        x[0, :, -1] = [mult * int(p) - 1 for p in primes]
        got, _ = _run(lambda xs, t, g: body(xs, t, g, lazy=True), x, tt, C)
        np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda a: jfn(a, jt))(x)))


@pytest.mark.parametrize("rank", [0, 1])
def test_sub_row_above_shared_memory(rank):
    """K1 sub_row on a 32768-coefficient chunk (N=65536 on two ranks) equals
    the in-core transform's chunk after the cross stage, both ways."""
    log_n, C = 16, 2
    n = 1 << log_n
    primes, _, tt = _tables(log_n, 1, bits=60)
    rng = np.random.default_rng(rank)
    x = to_tensor(_residues(rng, primes, (), n), "cpu")
    chunk = n // C
    own = x[..., rank * chunk:(rank + 1) * chunk].contiguous()
    partner = x[..., (1 - rank) * chunk:(2 - rank) * chunk].contiguous()
    after = tk.ntt_sp_exchange(own, partner, tt, rank, C, 0, inverse=False)
    got = tn.ntt_sub_row(after, tt, rank, C, inverse=False, canonical=True)
    want = tn.ntt_forward(x, tt)[..., rank * chunk:(rank + 1) * chunk]
    assert torch.equal(got, want)
    # the inverse: the chunk stages, then the last (exchange) stage
    f = tn.ntt_forward(x, tt)
    own, partner = (f[..., r * chunk:(r + 1) * chunk].contiguous() for r in (rank, 1 - rank))
    a = tn.ntt_sub_row(own, tt, rank, C, inverse=True)
    b = tn.ntt_sub_row(partner, tt, 1 - rank, C, inverse=True)
    got = tk.ntt_sp_exchange(a, b, tt, rank, C, log_n - 1, inverse=True, canonical=True)
    assert torch.equal(got, x[..., rank * chunk:(rank + 1) * chunk])


def test_exchange_params_follow_the_jax_loops():
    """Partner bit, twiddle index and the final-stage flag, for every rank
    and stage at C = 8, N = 64, against the JAX loops' arithmetic
    (ntt_sp.py:106-112, :188-199)."""
    n, C = 64, 8
    log_n, log_c, chunk = 6, 3, 8
    for d in range(C):
        for s in range(log_c):
            cd = C >> (s + 1)
            assert tk.exchange_params(n, C, s, d, False) == ((d & cd) == 0,
                                                             (1 << s) + (d >> (log_c - s)), False)
        ofs = [1]
        for s in range(log_n):
            ofs.append(ofs[-1] + (n >> (s + 1)))
        for s in range(log_n - log_c, log_n):
            cd = (1 << s) // chunk
            assert tk.exchange_params(n, C, s, d, True) == ((d & cd) == 0,
                                                            ofs[s] + d // (2 * cd),
                                                            (n >> (s + 1)) == 1)


def test_checks_match_the_jax_package():
    _, jt, tt = _tables(5, 1)
    for C in (3, 6):
        team = ThreadGroup(C, "cpu")
        with pytest.raises(ValueError, match="power of two"):
            run_spmd(lambda g, x: tsp.ntt_forward_sharded(x, tt, g), team,
                     [torch.zeros((1, 32 // C), dtype=torch.int64)] * C)
    with pytest.raises(ValueError, match="chunk >= C"):
        tsp.check_4step(32, 8)
    with pytest.raises(ValueError, match="need chunk >= C"):
        jsp._check_4step(32, 8)
    with pytest.raises(ValueError, match="chunk too small"):
        tsp.check_hypercube(32, 32)
