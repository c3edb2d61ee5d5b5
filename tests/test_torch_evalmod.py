"""The port's Chebyshev-cosine EvalMod and the Evaluator's modulus switch
against the JAX package on the CPU, exact equality.

- fit_cos_cheby, choose_r and plan_evalmod: the same doubles, at the
  bootstrap shapes of N = 128, 1024 and 4096 (K = 12, 34, 68) and the
  engine test's K = 3;
- ChebyEvalMod at the JAX test's ring (tests/test_evalmod.py:73-116: N=64,
  [59] + [45] x (depth + 1) + [59], K=3, r=2, seed (9, ..., 2)) with imag
  False and True: the same depth, output scale and product count, the
  output residues equal, and the decode within 1e-6 of sin(2 pi (K+1) y);
- Evaluator.mod_switch_to_next and mod_switch_to for CKKS (the limb drop)
  and BFV (the rounded division, per level and fused).

The JAX engine runs eagerly on numpy inputs: its per-level jit is swapped
for the identity and ``jax.numpy`` for numpy (monkeypatch), so nothing is
compiled.
"""

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import evalmod as je
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.evaluator import Evaluator
from gemini_seal_tpu_torch.models import evalmod as te
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("K,r", [(3, 2), (12, None), (34, None), (68, None), (68, 5)])
def test_host_planning(K, r):
    (rj, cj, dj), (rt, ct, dt) = je.plan_evalmod(K, r), te.plan_evalmod(K, r)
    assert (rj, dj) == (rt, dt)
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(je.fit_cos_cheby(K, rj), te.fit_cos_cheby(K, rj))
    (rcj, ccj), (rct, cct) = je.choose_r(K, r), te.choose_r(K, r)
    assert rcj == rct
    np.testing.assert_array_equal(ccj, cct)
    for d in (1, 2, 7, 26, 100, 255):
        assert te._plan_lt(d) == je._plan_lt(d)


def _chain(ctx, n_levels):
    cds = [ctx.first_context_data()]
    for _ in range(n_levels):
        cds.append(cds[-1].next_context_data)
    q = [cd.parms.coeff_modulus[-1].value for cd in cds]
    return cds, q, [cd.limb_constants for cd in cds], [len(cd.parms.coeff_modulus) for cd in cds]


class EngineRing:
    K, R = 3, 2

    def __init__(self):
        _, self.coeffs, self.depth = je.plan_evalmod(self.K, self.R)
        n = 64
        bits = [59] + [45] * (self.depth + 1) + [59]

        def setup(M, **kw):
            parms = M.EncryptionParameters(M.SchemeType.CKKS)
            parms.set_poly_modulus_degree(n)
            parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
            parms.set_random_seed((9, 8, 7, 6, 5, 4, 3, 2))
            return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)

        self.jc, self.tc = setup(J), setup(T, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.tkg = T.KeyGenerator(self.tc, device="cpu")
        self.jenc, self.tenc = J.CKKSEncoder(self.jc), T.CKKSEncoder(self.tc, device="cpu")
        self.jrk = self.jkg.relin_keys().stacked(2)
        self.trk = self.tkg.relin_keys().stacked(2)
        self.y = np.random.default_rng(21).uniform(-1, 1, n // 2)
        self.enc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.dec = T.Decryptor(self.tc, self.tkg.secret_key, device="cpu")


@pytest.fixture(scope="module")
def engine_ring():
    return EngineRing()


@pytest.mark.parametrize("imag", [False, True])
def test_cheby_evalmod(engine_ring, imag, monkeypatch):
    g = engine_ring
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax, "numpy", np)
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **k: x)
    Dl = 2.0 ** 45
    np.testing.assert_array_equal(np.asarray(g.jrk), to_numpy(g.trk))
    jem = je.ChebyEvalMod(g.jc, *_chain(g.jc, g.depth + 1), g.jenc, 0, Dl, g.coeffs,
                          g.R, imag)
    with contiguous_calls():
        tem = te.ChebyEvalMod(g.tc, *_chain(g.tc, g.depth + 1), g.tenc, 0, Dl, g.coeffs,
                              g.R, imag, device="cpu")
        assert (tem.depth, tem.sigma_z, tem.degree, tem.n_ct_mults, tem.r) == (
            jem.depth, jem.sigma_z, jem.degree, jem.n_ct_mults, jem.r)
        vals = (1j * g.y) if imag else g.y
        ct = np.asarray(g.enc.encrypt(g.jenc.encode(vals.tolist(), Dl)).data)
        want = np.asarray(jem.stage(ct, g.jrk))
        got = tem.stage(to_tensor(ct, "cpu"), g.trk)
    np.testing.assert_array_equal(want, to_numpy(got))
    out_pid = _chain(g.tc, g.depth + 1)[0][tem.depth].parms_id
    dec = np.asarray(g.tenc.decode(g.dec.decrypt(T.Ciphertext(got, out_pid, True, tem.sigma_z)),
                                   as_complex=True))
    want_sin = np.sin(2 * np.pi * (g.K + 1) * g.y)
    assert np.abs(dec.real - want_sin).max() < 1e-6
    assert np.abs(dec.imag).max() < 1e-6


def _ckks(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(256)
    parms.set_coeff_modulus(M.CoeffModulus.create(256, [50, 40, 40, 40, 50]))
    parms.set_random_seed(tuple(range(8)))
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


def _bfv(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.BFV)
    parms.set_poly_modulus_degree(256)
    parms.set_coeff_modulus(M.CoeffModulus.create(256, [40, 40, 40, 40, 40]))
    parms.set_plain_modulus(M.PlainModulus.batching(256, 20))
    parms.set_random_seed(tuple(range(8)))
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


@pytest.mark.parametrize("scheme", ["ckks", "bfv"])
def test_mod_switch(scheme):
    make = _ckks if scheme == "ckks" else _bfv
    jc, tc = make(J), make(T, device="cpu")
    jkg = J.KeyGenerator(jc)
    enc = J.Encryptor(jc, public_key=jkg.public_key())
    if scheme == "ckks":
        jct = enc.encrypt(J.CKKSEncoder(jc).encode([0.5, -0.25, 1.0], 2.0 ** 40))
    else:
        jct = enc.encrypt(J.BatchEncoder(jc).encode(list(range(256))))
    jev, tev = J.Evaluator(jc), Evaluator(tc, device="cpu")
    tct = T.Ciphertext(to_tensor(np.asarray(jct.data), "cpu"), jct.parms_id, jct.is_ntt_form,
                       jct.scale)
    with contiguous_calls():
        j1, t1 = jev.mod_switch_to_next(jct), tev.mod_switch_to_next(tct)
        assert (t1.parms_id, t1.is_ntt_form, t1.scale) == (j1.parms_id, j1.is_ntt_form,
                                                          j1.scale)
        np.testing.assert_array_equal(np.asarray(j1.data), to_numpy(t1.data))
        last = jc.last_parms_id
        for fused in (False, True):
            jl = jev.mod_switch_to(jct, last, fused=fused)
            tl = tev.mod_switch_to(tct, last, fused=fused)
            assert (tl.parms_id, tl.scale) == (jl.parms_id, jl.scale)
            np.testing.assert_array_equal(np.asarray(jl.data), to_numpy(tl.data))
        assert tev.mod_switch_to(tct, tct.parms_id) is tct
        # CKKS rescales only through the scheme-blind scale switch
        js, ts = jev._mod_switch_scale_to_next(jct), tev._mod_switch_scale_to_next(tct)
        assert ts.scale == js.scale
        np.testing.assert_array_equal(np.asarray(js.data), to_numpy(ts.data))
    with pytest.raises(ValueError, match="end of modulus switching chain"):
        tev.mod_switch_to_next(tl)
    with pytest.raises(ValueError, match="higher level"):
        tev.mod_switch_to(tl, jct.parms_id)
    if scheme == "ckks":
        with pytest.raises(ValueError, match="scale out of bounds"):
            tev._mod_switch_drop_to_next(T.Ciphertext(tct.data, tct.parms_id, True, 2.0 ** 140))
