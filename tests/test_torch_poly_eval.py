"""The port's CKKS scalar and complex encode and build_ckks_poly_eval
(BASELINE config 5's step) against the JAX package on the CPU, exact
equality, at the JAX test's ring (N=512, [59, 30, 30, 30, 59], scale 2^30):
both rotate modes ("tree": sequential rotations; "flat": one hoisted mod-up,
summed accumulators, one mod-down), fused on and off, composed on and off,
and the decode within 1e-3 of sum_{j<4} p(v_{i+j}) (tests/test_pipelines.py's
bound).  A non-finite scalar is refused.

The JAX steps run on numpy inputs through the package's host-plane dispatch
(``jnp`` of models/pipelines.py swapped for numpy), so nothing is compiled.
"""

import math

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

N = 512
BITS = [59, 30, 30, 30, 59]
SCALE = 2.0 ** 30
COEFFS = [1.0, -0.5, 0.25, 0.125, 0.0625]
STEPS = (1, 2, 3)


def _setup(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, BITS))
    parms.set_random_seed(tuple(range(8)))
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    return ctx, M.KeyGenerator(ctx, **kw), M.CKKSEncoder(ctx, **kw)


class Ring:
    def __init__(self):
        (self.jc, self.jkg, self.jenc), (self.tc, self.tkg, self.tenc) = (
            _setup(J), _setup(T, device="cpu"))
        tool = self.jc.first_context_data().galois_tool
        elts = tool.get_elts_from_steps(list(STEPS))
        jrk, jgk = self.jkg.relin_keys(), self.jkg.galois_keys(elts)
        self.jrk = np.stack([np.asarray(pk.data.data) for pk in jrk.key(2)])
        self.jgk = {e: np.stack([np.asarray(pk.data.data) for pk in jgk.key(e)]) for e in elts}
        self.trk = self.tkg.relin_keys().stacked(2)
        self.tgk = self.tkg.galois_keys(elts)
        self.elts = elts
        self.v = np.random.default_rng(7).uniform(-1.0, 1.0, N // 2)
        self.jct = J.Encryptor(self.jc, public_key=self.jkg.public_key()).encrypt(
            self.jenc.encode(self.v.tolist(), SCALE))
        self.a = np.stack([np.asarray(self.jct.data)] * 2)       # batch 2
        self.dec = T.Decryptor(self.tc, self.tkg.secret_key, device="cpu")


@pytest.fixture(scope="module")
def ring():
    return Ring()


@pytest.mark.parametrize("value", [0.0, 1.5, -2.25, 3, -0.0625, 2.0 ** 40 + 0.5, 1 + 2j])
def test_scalar_and_complex_encode(ring, value):
    deep = ring.jc.first_context_data().next_context_data.next_context_data.parms_id
    for scale, pid in ((SCALE, None), (2.0 ** 45 / 3, deep)):
        want = ring.jenc.encode(value, scale, pid)
        got = ring.tenc.encode(value, scale, pid)
        assert got.parms_id == want.parms_id and got.scale == want.scale
        np.testing.assert_array_equal(np.asarray(want.data), to_numpy(got.data))
    if isinstance(value, complex):
        return
    out = ring.tenc.decode(ring.tenc.encode(value, SCALE))
    assert max(abs(x - value) for x in out) < 1e-6
    with pytest.raises(ValueError, match="too large"):
        ring.tenc.encode((value or 1.0) * 2.0 ** 180, SCALE)


@pytest.mark.parametrize("value", [math.inf, -math.inf, math.nan, 1e300])
def test_scalar_encode_rejects_non_finite(ring, value):
    """inf, nan, and a finite value whose product with the scale overflows:
    math.frexp(inf) reports exponent 0, which the size check would pass."""
    with pytest.raises(ValueError, match="not finite"):
        ring.tenc.encode(value, SCALE)


def _p(x):
    return sum(c * x ** k for k, c in enumerate(COEFFS))


@pytest.mark.parametrize("rotate_mode,m", [("tree", 2), ("flat", 2), ("flat", 0)])
@pytest.mark.parametrize("fused", [False, True])
def test_poly_eval(ring, rotate_mode, m, fused, monkeypatch):
    """m = rotate_sum_log2: 2^m adjacent slots summed (m = 0: none, and no
    keys)."""
    monkeypatch.setattr(jp, "jnp", np)
    kw = dict(rotate_sum_log2=m, coeff_precision_bits=25, fused=fused,
              rotate_mode=rotate_mode)
    # steps 1..2^m - 1 (flat), or the powers of two below 2^m (tree)
    elts = ring.elts[: (1 << m) - 1] if rotate_mode == "flat" else ring.elts[: m]
    jstep, jdeep, jscale = jp.build_ckks_poly_eval(ring.jc, COEFFS, SCALE, ring.jenc, **kw)
    want = jstep(ring.a, ring.jrk, np.stack([ring.jgk[e] for e in elts]) if m else None)
    tstep, deep, out_scale = T.build_ckks_poly_eval(ring.tc, COEFFS, SCALE, ring.tenc,
                                                    device="cpu", **kw)
    assert (deep, out_scale) == (jdeep, jscale)
    x, gks = to_tensor(ring.a, "cpu"), ring.tgk.stacked(*elts) if m else None
    got = tstep(x, ring.trk, gks)
    np.testing.assert_array_equal(want, to_numpy(got))
    run, deep2, scale2 = T.build_ckks_poly_eval(ring.tc, COEFFS, SCALE, ring.tenc,
                                                composed=True, device="cpu", **kw)
    assert (deep2, scale2) == (deep, out_scale)
    np.testing.assert_array_equal(to_numpy(run(x, ring.trk, gks)), to_numpy(got))

    out = ring.tenc.decode(ring.dec.decrypt(T.Ciphertext(got[1], deep, True, out_scale)))
    expect = sum(_p(np.roll(ring.v, -j)) for j in range(1 << m))
    assert np.max(np.abs(np.asarray(out) - expect)) < 1e-3


def test_poly_eval_rejects(ring):
    with pytest.raises(ValueError, match="degree"):
        T.build_ckks_poly_eval(ring.tc, [1.0, 2.0], SCALE, ring.tenc, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        T.build_ckks_poly_eval(ring.tc, [1.0] * 7, SCALE, ring.tenc, device="cpu")
    with pytest.raises(ValueError, match="rotate_mode"):
        T.build_ckks_poly_eval(ring.tc, COEFFS, SCALE, ring.tenc, rotate_mode="ring",
                               device="cpu")
