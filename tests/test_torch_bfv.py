"""The port's BFV path against the JAX package, exact equality: relin keys,
BatchEncoder, public-key encryption and decryption under the pinned seed,
build_bfv_mul_relin (multiply and square) and
build_bfv_mul_relin_modswitch (fused_drop True and False), and the exact
decode of v^2 mod t.

Two rings at N=256: config 3's shape (five 40-bit primes: four ciphertext
primes and one special, the chain dropping three) and config 1's (three
primes: two ciphertext primes, a one-level chain).  The fused chain at
config 3's shape is compared with the jitted JAX step (the one compile of
this file); the other JAX steps run on numpy inputs through the package's
host-plane dispatch, with the step's two jnp calls (the uint64 scalar t and
the final stack) given their numpy twins, so that no op is compiled.
"""

import types

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import convert
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor

N = 256
RINGS = {"config3": [40] * 5, "config1": [36, 36, 37]}


def _setup(M, bits, **kw):
    parms = M.EncryptionParameters(M.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, bits))
    parms.set_plain_modulus(M.PlainModulus.batching(N, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)
    kg = M.KeyGenerator(ctx, **kw)
    return ctx, kg


class Ring:
    def __init__(self, bits):
        self.jc, self.jkg = _setup(J, bits)
        self.tc, self.tkg = _setup(T, bits, device="cpu")
        self.t = self.jc.first_context_data().parms.plain_modulus.value
        self.jbe, self.tbe = J.BatchEncoder(self.jc), T.BatchEncoder(self.tc, device="cpu")
        self.jenc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.tenc = T.Encryptor(self.tc, self.tkg.public_key(), device="cpu")
        self.jdec = J.Decryptor(self.jc, self.jkg.secret_key)
        self.tdec = T.Decryptor(self.tc, self.tkg.secret_key, device="cpu")
        self.jrk = np.stack([np.asarray(pk.data.data) for pk in self.jkg.relin_keys().key(2)])
        self.trk = self.tkg.relin_keys().stacked(2)
        self.v = np.random.default_rng(len(bits)).integers(0, self.t, N)
        self.sq = (self.v.astype(object) ** 2 % self.t).tolist()
        self.jct = self.jenc.encrypt(self.jbe.encode(self.v.tolist()))
        self.tct = self.tenc.encrypt(self.tbe.encode(self.v.tolist()))
        self.a = np.stack([np.asarray(self.jct.data)] * 2)      # batch 2


@pytest.fixture(scope="module", params=list(RINGS))
def ring(request):
    return Ring(RINGS[request.param])


@pytest.fixture
def host_plane(monkeypatch):
    """Calling it puts the JAX BFV steps built after it on numpy: the
    host-plane dispatch of every op they call, and numpy for the step's own
    jnp.uint64 and jnp.stack."""
    return lambda: monkeypatch.setattr(
        jp, "jnp", types.SimpleNamespace(uint64=np.uint64, stack=np.stack))


def test_keys_byte_equal(ring):
    np.testing.assert_array_equal(np.asarray(ring.jkg.secret_key.data),
                                  to_numpy(ring.tkg.secret_key.data))
    np.testing.assert_array_equal(np.asarray(ring.jkg.public_key().data.data),
                                  to_numpy(ring.tkg.public_key().data.data))
    np.testing.assert_array_equal(ring.jrk, to_numpy(ring.trk))


def test_batch_encoder(ring):
    rng = np.random.default_rng(11)
    rows = [ring.v.tolist(), rng.integers(-ring.t, ring.t, N // 3).tolist()]
    for j, t in zip(ring.jbe.encode_batch(rows), ring.tbe.encode_batch(rows)):
        np.testing.assert_array_equal(np.asarray(j.data), to_numpy(t.data))
        assert ring.tbe.decode(t, signed=True) == ring.jbe.decode(j, signed=True)
    plains = ring.tbe.encode_batch(rows)
    assert ring.tbe.decode_batch(plains) == [ring.jbe.decode(p) for p in
                                             ring.jbe.encode_batch(rows)]
    assert ring.tbe.decode(plains[0]) == ring.v.tolist()
    gen3 = T.BatchEncoder(ring.tc, compat_gen3=True, device="cpu")
    np.testing.assert_array_equal(
        to_numpy(gen3.encode(rows[0]).data),
        np.asarray(J.BatchEncoder(ring.jc, compat_gen3=True).encode(rows[0]).data))
    with pytest.raises(ValueError, match="larger than plain_modulus"):
        ring.tbe.encode([ring.t])


def test_encrypt_decrypt(ring):
    assert not ring.tct.is_ntt_form and ring.tct.parms_id == ring.jct.parms_id
    np.testing.assert_array_equal(np.asarray(ring.jct.data), to_numpy(ring.tct.data))
    jpt, tpt = ring.jdec.decrypt(ring.jct), ring.tdec.decrypt(ring.tct)
    np.testing.assert_array_equal(np.asarray(jpt.data), to_numpy(tpt.data))
    assert ring.tbe.decode(tpt) == ring.v.tolist()
    # a JAX-made ciphertext and plaintext carried in
    ct = convert.ciphertext_from_arrays(ring.tc, ring.jct.data, ring.jct.parms_id,
                                        ring.jct.is_ntt_form, ring.jct.scale)
    assert ring.tbe.decode(ring.tdec.decrypt(ct)) == ring.v.tolist()
    pt = convert.plaintext_from_array(ring.tc, np.asarray(jpt.data))
    assert ring.tbe.decode(pt) == ring.v.tolist()
    zero = ring.tdec.decrypt(ring.tenc.encrypt(ring.tbe.encode([0] * N)))
    assert to_numpy(zero.data).tolist() == [0]


def _check(ring, want, got, parms_id):
    np.testing.assert_array_equal(np.asarray(want), to_numpy(got))
    for b in range(got.shape[0]):
        pt = ring.tdec.decrypt(T.Ciphertext(got[b], parms_id, False))
        assert ring.tbe.decode(pt) == ring.sq


@pytest.mark.parametrize("square", [False, True])
def test_bfv_mul_relin(ring, square, host_plane):
    host_plane()
    a, ta, trk = ring.a, to_tensor(ring.a, "cpu"), ring.trk
    jf = jp.build_bfv_mul_relin(ring.jc, square=square)
    tf = T.build_bfv_mul_relin(ring.tc, square=square, device="cpu")
    want = jf(a, ring.jrk) if square else jf(a, a, ring.jrk)
    got = tf(ta, trk) if square else tf(ta, ta, trk)
    _check(ring, want, got, ring.tc.first_parms_id)


@pytest.mark.parametrize("fused_drop", [True, False])
def test_bfv_mul_relin_modswitch(ring, fused_drop, host_plane):
    a, ta = ring.a, to_tensor(ring.a, "cpu")
    jitted = fused_drop and len(ring.jc.first_context_data().parms.coeff_modulus) == 4
    if jitted:
        want = jax.jit(jp.build_bfv_mul_relin_modswitch(ring.jc))(a, a, ring.jrk)
    host_plane()
    host = jp.build_bfv_mul_relin_modswitch(ring.jc, fused_drop=fused_drop)(a, a, ring.jrk)
    if jitted:
        np.testing.assert_array_equal(np.asarray(want), host)
    want = host
    got = T.build_bfv_mul_relin_modswitch(ring.tc, fused_drop=fused_drop, device="cpu")(
        ta, ta, ring.trk)
    _check(ring, want, got, ring.tc.last_parms_id)
    # square form of the chain, and a target one level down
    first = ring.tc.first_context_data()
    target = first.next_context_data.parms_id
    sq = T.build_bfv_mul_relin_modswitch(ring.tc, target, fused_drop=fused_drop,
                                         square=True, device="cpu")(ta, ring.trk)
    want = jp.build_bfv_mul_relin_modswitch(ring.jc, target, fused_drop=fused_drop,
                                            square=True)(a, ring.jrk)
    _check(ring, want, sq, target)
