"""The port's host plane against the JAX package on the CPU, exact equality:
the native runtime's bindings (BLAKE2Xb, SEALHeader framing, CRT compose,
the fused decode ladder, the decomposition of rounded doubles) and the limb
helpers of utils/mplimb; the CKKS encoder's encode_int, encode_batch and
decode_batch and the vector encode and decode at scales of 2^40, 2^62,
2^70 and 2^100, each through the native host library and without it;
Decryptor.decrypt_batch for BFV (sizes 2 and 3) and CKKS, also against
per-ciphertext decrypt; valcheck, BigUInt, utils/polyarith and metrics
against their JAX modules.

Rings: BFV N=64 on [40, 40, 40] (t=257), CKKS N=64 on [40, 30, 40] and on
[59 x 4] for the large scales, parms seed range(91, 99).  The JAX package
makes keys and ciphertexts and convert.py carries them into the port;
nothing is compiled (the JAX host plane runs on numpy).
"""

import math

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu import biguint as jbiguint
from gemini_seal_tpu import metrics as jmetrics
from gemini_seal_tpu import valcheck as jvalcheck
from gemini_seal_tpu.ciphertext import Ciphertext as JCiphertext
from gemini_seal_tpu.ops import ntt as jntt
from gemini_seal_tpu.utils import mplimb as jmplimb
from gemini_seal_tpu.utils import native as jnative
from gemini_seal_tpu.utils import polyarith as jpolyarith
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import biguint as tbiguint
from gemini_seal_tpu_torch import metrics as tmetrics
from gemini_seal_tpu_torch import valcheck as tvalcheck
from gemini_seal_tpu_torch.convert import (ciphertext_from_arrays, plaintext_from_array,
                                           secret_key_from_array)
from gemini_seal_tpu_torch.keys import PublicKey
from gemini_seal_tpu_torch.ops import ntt as tntt
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.utils import mplimb as tmplimb
from gemini_seal_tpu_torch.utils import native as tnative
from gemini_seal_tpu_torch.utils import polyarith as tpolyarith
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

SEED = tuple(range(91, 99))


def _ring(M, scheme, bits, t=None, **kw):
    parms = M.EncryptionParameters(getattr(M.SchemeType, scheme))
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(M.CoeffModulus.create(64, bits))
    if t is not None:
        parms.set_plain_modulus(t)
    parms.set_random_seed(SEED)
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


class Ring:
    def __init__(self, scheme, bits, t=None):
        self.jc = _ring(J, scheme, bits, t)
        self.tc = _ring(T, scheme, bits, t, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.jenc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.jdec = J.Decryptor(self.jc, self.jkg.secret_key)
        self.sk = secret_key_from_array(self.tc, np.asarray(self.jkg.secret_key.data))
        self.dec = T.Decryptor(self.tc, self.sk, device="cpu")
        if scheme == "CKKS":
            self.jcod, self.tcod = J.CKKSEncoder(self.jc), T.CKKSEncoder(self.tc, device="cpu")

    def port_ct(self, jct):
        return ciphertext_from_arrays(self.tc, jct.data, jct.parms_id, jct.is_ntt_form,
                                      jct.scale)


@pytest.fixture(scope="module")
def bfv():
    return Ring("BFV", [40, 40, 40], 257)


@pytest.fixture(scope="module")
def ckks():
    return Ring("CKKS", [40, 30, 40])


@pytest.fixture(scope="module")
def wide():
    return Ring("CKKS", [59] * 4)


@pytest.fixture(params=["native", "pure"])
def host_route(request, monkeypatch):
    """The port with its native host library, or without it (the JAX
    package keeps its own)."""
    if request.param == "pure":
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert tnative.available()
    with contiguous_calls():
        yield request.param


def _residues(base, n, rng):
    return np.stack([rng.integers(0, m.value, n, dtype=np.uint64) for m in base.base])


def test_native_bindings_match_jax(wide):
    assert tnative.available() and jnative.available()
    rng = np.random.default_rng(5)
    data = rng.bytes(300)
    for out_len, key in ((64, b""), (200, b""), (4096, b"k" * 32)):
        assert tnative.blake2xb(out_len, data, key) == jnative.blake2xb(out_len, data, key)
    for compr in (0, 1):
        framed = tnative.frame(data, compr)
        assert framed == jnative.frame(data, compr)
        assert tnative.unframe(framed) == jnative.unframe(framed) == data
    assert tnative.prng_fill(3, SEED, 5) == jnative.prng_fill(3, SEED, 5)
    cd = wide.tc.first_context_data()
    base = cd.rns_base
    K = (cd.total_coeff_modulus.bit_length() + 63) // 64
    consts = tmplimb.native_compose_consts(base, K)
    jconsts = jmplimb.native_compose_consts(wide.jc.first_context_data().rns_base, K)
    for a, b in zip(consts, jconsts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    res = _residues(base, 128, rng)
    np.testing.assert_array_equal(tnative.crt_compose(res, *consts[1:], K),
                                  jnative.crt_compose(res, *jconsts[1:], K))
    upper = tmplimb.int_to_limbs(cd.upper_half_threshold, K)
    for inv_scale in (2.0 ** -40, 2.0 ** -100):
        np.testing.assert_array_equal(
            tnative.crt_centered_double(res, *consts[1:], upper, K, inv_scale),
            jnative.crt_centered_double(res, *jconsts[1:], upper, K, inv_scale))
    mods = np.asarray(base.values(), dtype=np.uint64)
    vals = np.concatenate([rng.uniform(-2.0 ** 120, 2.0 ** 120, 64),
                           rng.uniform(-2.0 ** 50, 2.0 ** 50, 64)])
    rounded = np.sign(vals) * np.floor(np.abs(vals) + 0.5)
    pow2 = J.CKKSEncoder._build_pow2_table(base.base, 130)
    np.testing.assert_array_equal(tnative.decompose_rounded(rounded, mods, pow2),
                                  jnative.decompose_rounded(rounded, mods, pow2))


def test_mplimb_helpers(wide, host_route):
    rng = np.random.default_rng(6)
    base = wide.tc.first_context_data().rns_base
    jbase = wide.jc.first_context_data().rns_base
    res = _residues(base, 256, rng)
    v = tmplimb.compose_limbs(res, base)
    np.testing.assert_array_equal(v, jmplimb.compose_limbs(res, jbase))
    assert tmplimb.limbs_to_ints(v) == jmplimb.limbs_to_ints(v) == tmplimb.compose_ints(res, base)
    K = v.shape[0]
    q = tmplimb.int_to_limbs(base.base_prod, K)[:, None]
    upper = tmplimb.int_to_limbs(base.base_prod // 2, K)[:, None]
    np.testing.assert_array_equal(tmplimb.geq_limbs(v, upper), jmplimb.geq_limbs(v, upper))
    np.testing.assert_array_equal(tmplimb.sub_from_limbs(q, v), jmplimb.sub_from_limbs(q, v))
    mask = tmplimb.geq_limbs(v, upper)
    a, b = v.copy(), v.copy()
    tmplimb.sub_limbs_masked(a, upper, mask)
    jmplimb.sub_limbs_masked(b, upper, mask)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmplimb.ladder_to_double(v, 2.0 ** -100),
                                  jmplimb.ladder_to_double(v, 2.0 ** -100))


def _pt_data(p):
    return to_numpy(p.data)


@pytest.mark.parametrize("scale_bits", [40, 62, 70, 100])
def test_vector_encode_and_decode(scale_bits, wide, host_route):
    """The vector encode at 2^62 and above decomposes through
    gst_decompose_rounded (native) or Python ints (pure); the decode
    composes through gst_crt_centered_double or the limb planes: both equal
    to the JAX package's encode and decode."""
    rng = np.random.default_rng(scale_bits)
    scale = 2.0 ** scale_bits
    vals = rng.uniform(-1, 1, 32).tolist()
    cvals = (rng.uniform(-1, 1, 32) + 1j * rng.uniform(-1, 1, 32)).tolist()
    for v in (vals, cvals, vals[:5]):
        jpt = wide.jcod.encode(v, scale)
        tpt = wide.tcod.encode(v, scale)
        np.testing.assert_array_equal(_pt_data(tpt), np.asarray(jpt.data))
        assert wide.tcod.decode(tpt, as_complex=True) == wide.jcod.decode(jpt, as_complex=True)
        assert wide.tcod.decode(tpt) == wide.jcod.decode(jpt)
    # the batch forms: one embedding, one decomposition and one NTT
    rows = [vals, cvals, vals[:3]]
    tpts = wide.tcod.encode_batch(rows, scale)
    jpts = wide.jcod.encode_batch(rows, scale)
    for t, j in zip(tpts, jpts):
        np.testing.assert_array_equal(_pt_data(t), np.asarray(j.data))
        assert (t.parms_id, t.scale) == (j.parms_id, j.scale)
    assert wide.tcod.decode_batch(tpts) == wide.jcod.decode_batch(jpts)
    assert wide.tcod.decode_batch(tpts, as_complex=True) == \
        [wide.tcod.decode(t, as_complex=True) for t in tpts]
    assert wide.tcod.encode_batch([], scale) == [] and wide.tcod.decode_batch([]) == []


def test_encode_int_and_batch_rules(ckks, wide):
    for ring in (ckks, wide):
        cd = ring.tc.first_context_data()
        for value in (0, 7, -7, 2 ** 80 + 3, -(2 ** 70) + 1):
            for pid in (cd.parms_id, cd.next_context_data.parms_id):
                t = ring.tcod.encode_int(value, pid)
                j = ring.jcod.encode_int(value, pid)
                np.testing.assert_array_equal(_pt_data(t), np.asarray(j.data))
                assert (t.parms_id, t.scale) == (j.parms_id, j.scale)
    pts = ckks.tcod.encode_batch([[0.5], [0.25]], 2.0 ** 20)
    with pytest.raises(ValueError, match="homogeneous"):
        ckks.tcod.decode_batch([pts[0], ckks.tcod.encode([0.5], 2.0 ** 21)])
    with pytest.raises(ValueError, match="too large"):
        ckks.tcod.encode_batch([[0.5] * 33], 2.0 ** 20)
    with pytest.raises(ValueError, match="scale out of bounds"):
        ckks.tcod.encode_batch([[0.5]], 2.0 ** 200)


def _stack_decrypt(ring, jcts, scheme):
    jdata = np.stack([np.asarray(c.data) for c in jcts])
    meta = (jcts[0].parms_id, jcts[0].is_ntt_form, jcts[0].scale)
    want = ring.jdec.decrypt_batch(jdata, *meta)
    got = ring.dec.decrypt_batch(to_tensor(jdata, "cpu"), *meta)
    assert len(got) == len(want) == len(jcts)
    for g, w, jct in zip(got, want, jcts):
        np.testing.assert_array_equal(_pt_data(g), np.asarray(w.data))
        assert (g.parms_id, g.scale) == (w.parms_id, w.scale)
        one = ring.dec.decrypt(ring.port_ct(jct))
        np.testing.assert_array_equal(_pt_data(g), _pt_data(one))
    # a host array goes up to the decryptor's device
    host = ring.dec.decrypt_batch(jdata, *meta)
    np.testing.assert_array_equal(_pt_data(host[-1]), _pt_data(got[-1]))
    return got


def test_decrypt_batch(bfv, ckks):
    with contiguous_calls():
        pts = [J.Plaintext.from_hex(h) for h in ("5x^3 + 4x^1 + 3", "0", "1x^63 + 100")]
        jcts = [bfv.jenc.encrypt(p) for p in pts]
        got = _stack_decrypt(bfv, jcts, "BFV")
        assert [g.to_hex() for g in got] == ["5x^3 + 4x + 3", "0", "1x^63 + 100"]
        # size 3: products before relinearization
        jev = J.Evaluator(bfv.jc)
        _stack_decrypt(bfv, [jev.multiply(jcts[0], jcts[2]), jev.multiply(jcts[0], jcts[0])],
                       "BFV")
        vals = [[0.5, -1.25], [2.0], [0.0, 0.125, -3.0]]
        jcts = [ckks.jenc.encrypt(ckks.jcod.encode(v, 2.0 ** 30)) for v in vals]
        got = _stack_decrypt(ckks, jcts, "CKKS")
        for row, v in zip(ckks.tcod.decode_batch(got), vals):
            assert max(abs(a - b) for a, b in zip(row, v)) < 1e-4
        pid = jcts[0].parms_id
        with pytest.raises(ValueError, match="must be in NTT form"):
            ckks.dec.decrypt_batch(to_tensor(np.stack([np.asarray(c.data) for c in jcts]),
                                             "cpu"), pid, False)
        with pytest.raises(ValueError, match="expects"):
            ckks.dec.decrypt_batch(ckks.port_ct(jcts[0]).data, pid, True)


def _valcheck_cases(ring, scheme):
    """(name, JAX object, port object) for valcheck, valid and not."""
    jct = ring.jenc.encrypt(J.Plaintext.from_hex("3x^2 + 1") if scheme == "BFV"
                            else ring.jcod.encode([0.5], 2.0 ** 30))
    cases = [("ciphertext", jct, ring.port_ct(jct))]
    bad = np.asarray(jct.data).copy()
    bad[1, 0, 3] = (1 << 63) | 1
    cases.append(("bit63", JCiphertext(bad, jct.parms_id, jct.is_ntt_form, jct.scale),
                  ciphertext_from_arrays(ring.tc, bad, jct.parms_id, jct.is_ntt_form,
                                         jct.scale)))
    bad = np.asarray(jct.data).copy()
    bad[0, 1, 0] = ring.jc.first_context_data().parms.coeff_modulus[1].value
    cases.append(("at_p", JCiphertext(bad, jct.parms_id, jct.is_ntt_form, jct.scale),
                  ciphertext_from_arrays(ring.tc, bad, jct.parms_id, jct.is_ntt_form,
                                         jct.scale)))
    jpk = ring.jkg.public_key()
    tpk_ct = ciphertext_from_arrays(ring.tc, jpk.data.data, jpk.parms_id, True, 1.0)
    cases += [("key_level_ciphertext", jpk.data, tpk_ct),
              ("public_key", jpk, PublicKey(tpk_ct, jpk.parms_id)),
              ("secret_key", ring.jkg.secret_key, ring.sk)]
    if scheme == "BFV":
        for hexp in ("3x^2 + 1", "100x^1"):
            p = J.Plaintext.from_hex(hexp)
            cases.append((hexp, p, plaintext_from_array(ring.tc, p.data)))
    else:
        p = ring.jcod.encode([0.5], 2.0 ** 30)
        cases.append(("ckks_plaintext", p, plaintext_from_array(ring.tc, p.data, p.parms_id,
                                                                p.scale)))
    return cases


def test_valcheck_matches_jax(bfv, ckks):
    big = J.Plaintext(np.array([300, 5], dtype=np.uint64))
    for ring, scheme in ((bfv, "BFV"), (ckks, "CKKS")):
        cases = _valcheck_cases(ring, scheme)
        if scheme == "BFV":
            cases.append(("coeff_at_t", big, plaintext_from_array(ring.tc, big.data)))
        for name, j, t in cases:
            for fn in ("is_metadata_valid_for", "is_data_valid_for", "is_valid_for"):
                assert getattr(tvalcheck, fn)(t, ring.tc) == getattr(jvalcheck, fn)(j, ring.jc), \
                    (scheme, name, fn)
            assert tvalcheck.is_buffer_valid(t) == jvalcheck.is_buffer_valid(j), (scheme, name)
    verdicts = {name: tvalcheck.is_valid_for(t, bfv.tc) for name, _, t in _valcheck_cases(bfv,
                                                                                          "BFV")}
    assert verdicts["ciphertext"] and not verdicts["bit63"] and not verdicts["at_p"]
    assert not tvalcheck.is_metadata_valid_for(bfv.port_ct(bfv.jkg.public_key().data), bfv.tc)
    assert not tvalcheck.is_valid_for(object(), bfv.tc)


def test_biguint_matches_jax():
    ops = [lambda B: B("1F2E3D4C5B6A7988", 80) + B(0x123456789, 80),
           lambda B: B("FF", 8) + 1,
           lambda B: B(5, 16) - 7,
           lambda B: B(2 ** 70 + 11, 100) * B(2 ** 40 + 3, 100),
           lambda B: B(2 ** 90 + 77, 96) // 12345,
           lambda B: B(2 ** 90 + 77, 96) % 12345,
           lambda B: B(0xF0F0, 16) ^ B(0x0FF0, 16),
           lambda B: B(0xF0F0, 16) & 0x0FF0,
           lambda B: B(0xF0F0, 16) | 0x000F,
           lambda B: B(3, 8) << 7,
           lambda B: B(2 ** 70, 72) >> 65,
           lambda B: B(17, 64).modinv(3233),
           lambda B: B(4, 64).trypow(13, 497),
           lambda B: B.load(B(2 ** 130 + 9, 140).save(), 140)]
    for op in ops:
        t, j = op(tbiguint.BigUInt), op(jbiguint.BigUInt)
        assert (int(t), t.bit_count, t.to_string(), t.to_dec_string(), repr(t)) == \
            (int(j), j.bit_count, j.to_string(), j.to_dec_string(), repr(j))
    x, y = tbiguint.BigUInt(2 ** 100 + 5), jbiguint.BigUInt(2 ** 100 + 5)
    assert x.save() == y.save()
    assert (x.uint64_count, x.byte_count, x.significant_bit_count(), x.is_zero()) == \
        (y.uint64_count, y.byte_count, y.significant_bit_count(), y.is_zero())
    assert [int(v) for v in x.divrem(977)] == [int(v) for v in y.divrem(977)]
    x.resize(40)
    y.resize(40)
    assert (int(x), x.bit_count) == (int(y), y.bit_count)
    with pytest.raises(ValueError):
        tbiguint.BigUInt(-1)


def test_polyarith_matches_jax():
    rng = np.random.default_rng(8)
    a = [int(v) for v in rng.integers(0, 2 ** 62, 9)] + [2 ** 100 + 3]
    b = [int(v) for v in rng.integers(0, 2 ** 62, 6)]
    for fn, args in (("right_shift_poly_coeffs", (a, 7)), ("negate_poly", (a, 128)),
                     ("add_poly", (a, b, 64)), ("sub_poly", (b, a, 64)),
                     ("multiply_poly", (a, b)), ("multiply_poly", (a, b, 5)),
                     ("multiply_poly", ([], b, 3)), ("poly_infty_norm", (a,)),
                     ("poly_eval_poly", (b[:3], a[:4]))):
        assert getattr(tpolyarith, fn)(*args) == getattr(jpolyarith, fn)(*args), fn


def test_metrics_match_jax(bfv, ckks):
    with contiguous_calls():
        jct = bfv.jenc.encrypt(J.Plaintext.from_hex("3x^2 + 1"))
        tct = bfv.port_ct(jct)
        cd = bfv.tc.first_context_data()
        jcd = bfv.jc.first_context_data()
        jntt_ct = JCiphertext(np.asarray(jntt.ntt_forward(np.asarray(jct.data), jcd.ntt_tables)),
                              jct.parms_id, True, jct.scale)
        tntt_ct = T.Ciphertext(tntt.ntt_forward(tct.data, cd.ntt_tables), tct.parms_id, True,
                               tct.scale)
        cases = [(jct, tct, bfv, None), (jct, tct, bfv, "dec"), (jntt_ct, tntt_ct, bfv, "dec")]
        jck = ckks.jenc.encrypt(ckks.jcod.encode([0.5], 2.0 ** 30))
        cases.append((jck, ckks.port_ct(jck), ckks, "dec"))
        for j, t, ring, dec in cases:
            want = jmetrics.inspect(j, ring.jc, ring.jdec if dec else None)
            got = tmetrics.inspect(t, ring.tc, ring.dec if dec else None)
            assert got.__dict__ == want.__dict__
            for bits in (0, 10, 30):
                if want.scheme == "BFV" and want.noise_budget_bits is None:
                    with pytest.raises(ValueError, match="Decryptor"):
                        got.headroom_ok(bits)
                else:
                    assert got.headroom_ok(bits) == want.headroom_ok(bits)
        assert math.isfinite(got.log2_scale)
