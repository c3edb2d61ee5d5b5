"""The port's CKKS bootstrap against the JAX package on the CPU, exact
equality.

- the host helpers of models/bootstrap.py: plan_bootstrap_chain, the slot
  matrices, their diagonals, the butterfly stages and their collapsed
  groups, the same doubles;
- mod_raise at N=64 (the JAX test's ring, tests/test_bootstrap.py:110-133)
  on random residues and on the boundary residues 0, q0/2, q0/2 + 1 and
  q0 - 1, and the kernel's plain version against Python integers;
- the full refresh at N=128 in four configurations, each with the JAX
  test's tolerance on the decode (tests/test_bootstrap.py:190-289):
  split/cosine at radix 3 on plan_bootstrap_chain's layout (1e-6),
  dense/cosine on the 45-bit layout (1e-4), dense/exp at r=8 on the 45-bit
  layout (2e-3), and split/cosine with two special primes and a short last
  bundle (plan_bootstrap_chain(128, radix=3, nsp=2, restored=2): 17
  ciphertext primes in 9 bundles; 1e-6).  composed=True equals
  composed=False.

The JAX functions run eagerly on numpy inputs (``jax.jit`` swapped for the
identity, ``jax.numpy`` and models/pipelines.py's ``jnp`` for numpy), so
nothing is compiled.  Every kernel call of the port is held to the
contiguity the card demands (torch_helpers.py).

test_bench_all_cell_digests (marked slow, about 75 s) recomputes, from the
JAX package, the sha256 digests that chip_smoke.py holds the card's refresh
at bench_all.py's N=4096 cell to.
"""

import hashlib
import math
import os
import sys

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.ciphertext import Ciphertext as JCiphertext
from gemini_seal_tpu.models import bootstrap as jb
from gemini_seal_tpu.models import pipelines as jp
from gemini_seal_tpu.models.evalmod import plan_evalmod
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.convert import galois_stack_from_array, relin_keys_from_array
from gemini_seal_tpu_torch.models import bootstrap as tb
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.ops.modraise import mod_raise_lift_plain
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SCALE = 2.0 ** 45


@pytest.fixture
def eager_jax(monkeypatch):
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax, "numpy", np)
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **k: x)
    monkeypatch.setattr(jp, "jnp", np)
    with contiguous_calls():
        yield


def _context(M, n, bits, nsp=1, seed=tuple(range(8)), **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(seed)
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


@pytest.mark.parametrize("n,radix,nsp,restored", [(128, 3, 1, 1), (1024, 4, 2, 1),
                                                  (4096, 4, 3, 2), (65536, 5, 3, 10)])
def test_plan_bootstrap_chain(n, radix, nsp, restored):
    want = jb.plan_bootstrap_chain(n, radix=radix, nsp=nsp, restored=restored)
    assert tb.plan_bootstrap_chain(n, radix=radix, nsp=nsp, restored=restored) == want


@pytest.mark.parametrize("n", [64, 128])
def test_slot_helpers(n):
    jenc = J.CKKSEncoder(_context(J, n, [45, 45]))
    tenc = T.CKKSEncoder(_context(T, n, [45, 45], device="cpu"), device="cpu")
    s = tenc.slots
    for a, b in zip(jb.derive_slot_matrices(jenc), tb.derive_slot_matrices(tenc)):
        np.testing.assert_array_equal(a, b)
    M = np.random.default_rng(7).normal(size=(s, s)) * (1 + 1j)
    dj, dt = jb._matrix_diagonals(M), tb._matrix_diagonals(M)
    assert list(dj) == list(dt)
    for d in dj:
        np.testing.assert_array_equal(dj[d], dt[d])
    (fj, ij), (ft, it) = (jb.special_fft_stage_diagonals(jenc),
                          tb.special_fft_stage_diagonals(tenc))

    def same(A, B):
        assert list(A) == list(B)
        for d in A:
            np.testing.assert_array_equal(A[d], B[d])

    for A, B in zip(fj + ij, ft + it):
        same(A, B)
    for radix in (2, 3, 4):
        for stages in (fj, list(reversed(ij))):
            for A, B in zip(jb._collapse_chain(stages, s, radix),
                            tb._collapse_chain(stages, s, radix)):
                same(A, B)
                same(jb._scale_diagonals(A, 0.25 - 1j), tb._scale_diagonals(B, 0.25 - 1j))
    same(jb.compose_diagonals(fj[1], ij[0], s), tb.compose_diagonals(fj[1], ij[0], s))


def test_mod_raise(eager_jax):
    n = 64
    jc = _context(J, n, [59, 40, 40, 41, 59], seed=(1, 2, 3, 4, 5, 6, 7, 8))
    tc = _context(T, n, [59, 40, 40, 41, 59], seed=(1, 2, 3, 4, 5, 6, 7, 8), device="cpu")
    jtop, ttop = jc.first_context_data(), tc.first_context_data()
    jlast, tlast = jc.last_context_data(), tc.last_context_data()
    jplan = jb.ModRaisePlan(jc, jlast.parms_id, jtop.parms_id)
    tplan = tb.ModRaisePlan(tc, tlast.parms_id, ttop.parms_id)
    q0 = tplan.q0
    assert (q0, tplan.half) == (jplan.q0, int(jplan.half))
    c = np.random.default_rng(11).integers(0, q0, size=(3, 2, 1, n), dtype=np.uint64)
    pins = np.array([0, q0 >> 1, (q0 >> 1) + 1, q0 - 1], dtype=np.uint64)
    c[0, 0, 0, :4] = pins
    c[2, 1, 0, -4:] = pins
    from gemini_seal_tpu.ops.ntt import ntt_forward as jntt
    x = jntt(c, jlast.ntt_tables)
    want = np.asarray(jb.mod_raise(x, jplan))
    got = tb.mod_raise(to_tensor(x, "cpu"), tplan)
    np.testing.assert_array_equal(want, to_numpy(got))
    np.testing.assert_array_equal(want[1], to_numpy(tb.mod_raise(to_tensor(x[1], "cpu"),
                                                                 tplan)))
    # the lift itself against Python integers, boundary residues included
    lifted = to_numpy(mod_raise_lift_plain(to_tensor(c, "cpu"), tplan.p, tplan.ratio1,
                                           tplan.q0_mod_p, tplan.half))
    ps = [m.value for m in ttop.parms.coeff_modulus]
    for idx in [(0, 0, 0, k) for k in range(6)] + [(2, 1, 0, k) for k in range(n - 6, n)]:
        v = int(c[idx])
        v = v - q0 if v > q0 // 2 else v
        assert [int(lifted[idx[:2] + (j, idx[3])]) for j in range(len(ps))] == [v % p for p in ps]


def _legacy_bits(n, evalmod, r, nsp):
    """The JAX test's 45-bit layout (tests/test_bootstrap.py:208-227)."""
    if evalmod == "exp":
        em_depth = 4 + r
    else:
        K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
        em_depth = plan_evalmod(K)[2]
    return [59] + [45] * 2 + [45] * (4 + em_depth - 1) + [59] * nsp


CONFIGS = {
    # name: (bits, nsp, options, decode tolerance)
    "split_cosine": (jb.plan_bootstrap_chain(128, radix=3, nsp=1, restored=1)[0], 1,
                     dict(linear_mode="split", radix=3), 1e-6),
    "dense_cosine": (_legacy_bits(128, "cosine", None, 1), 1, dict(linear_mode="dense"), 1e-4),
    "dense_exp": (_legacy_bits(128, "exp", 8, 1), 1,
                  dict(linear_mode="dense", evalmod="exp", r=8), 2e-3),
    "split_nsp2_short_bundle": (jb.plan_bootstrap_chain(128, radix=3, nsp=2, restored=2)[0],
                                2, dict(linear_mode="split", radix=3), 1e-6),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh(name, eager_jax):
    bits, nsp, opts, tol = CONFIGS[name]
    n = 128
    jc, tc = _context(J, n, bits, nsp), _context(T, n, bits, nsp, device="cpu")
    jenc, tenc = J.CKKSEncoder(jc), T.CKKSEncoder(tc, device="cpu")
    if name == "split_nsp2_short_bundle":
        n_ct = len(jc.first_context_data().parms.coeff_modulus)
        assert (n_ct, -(-n_ct // nsp)) == (17, 9)
    jfn, jpid, jscale, jsteps, jconj = jb.build_ckks_bootstrap(jc, SCALE, jenc, **opts)
    tfn, pid, out_scale, steps, conj = tb.build_ckks_bootstrap(tc, SCALE, tenc, device="cpu",
                                                              **opts)
    assert (pid, out_scale, steps, conj) == (jpid, jscale, jsteps, jconj)
    assert math.isclose(out_scale, SCALE, rel_tol=1e-9)

    jkg = J.KeyGenerator(jc)
    tool = jc.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = jkg.galois_keys(elts + [conj])
    rot, conj_key, rk = gk.stacked(*elts), gk.stacked(conj), jkg.relin_keys().stacked(2)
    rng = np.random.default_rng(13)
    msg = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = J.Encryptor(jc, public_key=jkg.public_key()).encrypt(jenc.encode(msg.tolist(), SCALE))
    ev = J.Evaluator(jc)
    while jc.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    x = np.asarray(ct.data)
    want = np.asarray(jfn(x, rot, conj_key, rk))
    targs = (to_tensor(x, "cpu"), galois_stack_from_array(tc, rot),
             galois_stack_from_array(tc, conj_key), relin_keys_from_array(tc, rk).stacked(2))
    got = tfn(*targs)
    np.testing.assert_array_equal(want, to_numpy(got))
    if name == "split_cosine":
        gfn = tb.build_ckks_bootstrap(tc, SCALE, tenc, composed=False, device="cpu", **opts)[0]
        np.testing.assert_array_equal(to_numpy(gfn(*targs)), want)
    dec = J.Decryptor(jc, jkg.secret_key)
    out = np.asarray(jenc.decode(dec.decrypt(JCiphertext(to_numpy(got), pid, True, out_scale)),
                                 as_complex=True))
    assert np.abs(out - msg).max() < tol
    assert len(tc.get_context_data(pid).parms.coeff_modulus) >= 2


def test_bootstrap_rejects():
    tc = _context(T, 128, [59, 45, 59], device="cpu")
    tenc = T.CKKSEncoder(tc, device="cpu")
    for kw, match in ((dict(evalmod="sine"), "evalmod"), (dict(linear_mode="fft"), "linear_mode"),
                      (dict(linear_mode="split"), "too short")):
        with pytest.raises(ValueError, match=match):
            tb.build_ckks_bootstrap(tc, SCALE, tenc, device="cpu", **kw)


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.uint64).tobytes()).hexdigest()


@pytest.mark.slow
def test_bench_all_cell_digests(eager_jax):
    """bench_all.py's bootstrap cell (bench_all.py:445-508), run by the JAX
    package eagerly on the CPU: the digests of the exhausted input and of
    the refreshed output, and the refresh error, that chip_smoke.py
    expects of the port on the card."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    n, radix, nsp = 4096, 4, 3
    bits, n_levels, _ = jb.plan_bootstrap_chain(n, radix=radix, nsp=nsp, restored=2)
    ctx = _context(J, n, bits, nsp)
    kg = J.KeyGenerator(ctx)
    enc = J.Encryptor(ctx, public_key=kg.public_key())
    encoder = J.CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    fn, out_pid, out_scale, rsteps, conj_elt = jb.build_ckks_bootstrap(
        ctx, SCALE, encoder, linear_mode="split", radix=radix)
    elts = [tool.get_elt_from_step(s) for s in rsteps]
    gk = kg.galois_keys(elts + [conj_elt])
    rot, conj, rks = gk.stacked(*elts), gk.stacked(conj_elt), kg.relin_keys().stacked(2)
    ev = J.Evaluator(ctx)
    msg = np.random.default_rng(13).uniform(-1, 1, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(msg.tolist(), SCALE))
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    out = np.asarray(fn(np.asarray(ct.data), rot, conj, rks))
    got = np.asarray(encoder.decode(J.Decryptor(ctx, kg.secret_key).decrypt(
        JCiphertext(out, out_pid, True, out_scale)), as_complex=True))
    want = chip_smoke.BOOTSTRAP_N4096
    assert _digest(np.asarray(ct.data)) == want["input_sha256"]
    assert _digest(out) == want["output_sha256"]
    assert float(np.abs(got - msg).max()) == want["max_err"]
    assert (len(rsteps), out.shape[1], n_levels) == (want["rotation_steps"],
                                                     want["levels_restored"],
                                                     want["levels_consumed"])
