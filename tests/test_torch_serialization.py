"""The port's SEAL wire format against the JAX package on the CPU, byte for
byte: ``save`` of every object type (parameters, modulus, BFV and CKKS
plaintexts, ciphertext, secret, public, relin and Galois keys, both
seed-compressed wrappers) in COMPR_NONE and COMPR_DEFLATE, with the native
host library and without it; blobs loaded across the packages with equal
arrays; the JAX package's own cases of tests/test_serialization.py run
through both packages with the same accepts and rejects (the SEAL 3.4
header, the corruption fuzz of the ciphertext, key-switch, parameter and
seeded loaders, truncated streams, ``save_size`` of plain and seeded
objects); residues at p and with bit 63 set rejected by both; pinned-seed
symmetric and seeded encryption, ``sk_power`` and the serializable relin
and Galois keys equal in both.

The rings are the JAX test's: BFV N=64 on [40, 40, 40] with t=257 and CKKS
N=64 on [40, 30, 40], parms seed range(91, 99).  The JAX package makes the
keys and ciphertexts; convert.py carries them into the port.  Nothing is
compiled (the JAX host plane runs on numpy).

test_ex6_digests (marked slow) recomputes from the JAX package the sha256
digests of examples/ex6's flow that chip_smoke.py holds the card to.
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu import serialization as jser
from gemini_seal_tpu import valcheck as jvalcheck
from gemini_seal_tpu.utils import native as jnative
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import serialization as tser
from gemini_seal_tpu_torch import valcheck as tvalcheck
from gemini_seal_tpu_torch.convert import (ciphertext_from_arrays, galois_keys_from_arrays,
                                           plaintext_from_array, relin_keys_from_array,
                                           secret_key_from_array)
from gemini_seal_tpu_torch.keys import PublicKey
from gemini_seal_tpu_torch.ops.backend import to_numpy
from gemini_seal_tpu_torch.utils import native as tnative
from torch_helpers import one_torch_thread  # noqa: F401

SEED = tuple(range(91, 99))
COMPR = (tser.COMPR_NONE, tser.COMPR_DEFLATE)
LOAD_ERRORS = (ValueError, TypeError, EOFError, OverflowError, MemoryError, IndexError,
               KeyError, zlib.error)


def _parms(M, scheme):
    parms = M.EncryptionParameters(getattr(M.SchemeType, scheme))
    parms.set_poly_modulus_degree(64)
    if scheme == "BFV":
        parms.set_coeff_modulus(M.CoeffModulus.create(64, [40, 40, 40]))
        parms.set_plain_modulus(257)
    else:
        parms.set_coeff_modulus(M.CoeffModulus.create(64, [40, 30, 40]))
    parms.set_random_seed(SEED)
    return parms


def _key_array(keys, idx):
    return np.stack([np.asarray(pk.data.data) for pk in keys.key(idx)])


class Ring:
    """One ring in both packages: the JAX package's keys and a ciphertext,
    and the same objects carried into the port."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.jparms, self.tparms = _parms(J, scheme), _parms(T, scheme)
        self.jc = J.SealContext(self.jparms, sec_level=J.SecLevelType.none)
        self.tc = T.SealContext(self.tparms, sec_level=T.SecLevelType.none, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.sk = secret_key_from_array(self.tc, np.asarray(self.jkg.secret_key.data))
        jpk = self.jkg.public_key()
        self.pk = PublicKey(ciphertext_from_arrays(self.tc, jpk.data.data, jpk.parms_id, True,
                                                   1.0), jpk.parms_id)
        self.jrk = self.jkg.relin_keys()
        self.rk = relin_keys_from_array(self.tc, _key_array(self.jrk, 2))
        self.elts = [self.jc.first_context_data().galois_tool.get_elt_from_step(1), 127]
        self.jgk = self.jkg.galois_keys(self.elts)
        self.gk = galois_keys_from_arrays(self.tc, {e: _key_array(self.jgk, e)
                                                    for e in self.elts})
        jenc = J.Encryptor(self.jc, public_key=jpk)
        if scheme == "BFV":
            self.jpt = J.Plaintext.from_hex("5x^3 + 4x^1 + 3")
            self.pt = plaintext_from_array(self.tc, self.jpt.data)
        else:
            self.jpt = J.CKKSEncoder(self.jc).encode([0.5, -1.25, 2.0], 2.0 ** 30)
            self.pt = plaintext_from_array(self.tc, self.jpt.data, self.jpt.parms_id,
                                           self.jpt.scale)
        self.jct = jenc.encrypt(self.jpt)
        self.ct = self.port_ct(self.jct)

    def port_ct(self, jct):
        return ciphertext_from_arrays(self.tc, jct.data, jct.parms_id, jct.is_ntt_form,
                                      jct.scale)

    def pairs(self):
        """(name, JAX object, port object) of every object type."""
        jsct = J.SerializableCiphertext(self.jct, SEED)
        srows = [[tuple(s ^ (7 * b + 1) for s in SEED) for b in range(len(row))]
                 for row in self.jrk.keys]
        return [("parms", self.jparms, self.tparms),
                ("modulus", self.jparms.coeff_modulus[1], self.tparms.coeff_modulus[1]),
                ("plaintext", self.jpt, self.pt),
                ("ciphertext", self.jct, self.ct),
                ("secret_key", self.jkg.secret_key, self.sk),
                ("public_key", self.jkg.public_key(), self.pk),
                ("relin_keys", self.jrk, self.rk),
                ("galois_keys", self.jgk, self.gk),
                ("serializable_ciphertext", jsct, tser.SerializableCiphertext(self.ct, SEED)),
                ("serializable_kswitch_keys", J.SerializableKSwitchKeys(self.jrk, srows),
                 tser.SerializableKSwitchKeys(self.rk, srows))]


@pytest.fixture(scope="module")
def bfv():
    return Ring("BFV")


@pytest.fixture(scope="module")
def ckks():
    return Ring("CKKS")


@pytest.fixture(params=["native", "pure"])
def host_route(request, monkeypatch):
    """Both packages with their native host library, or both without it."""
    if request.param == "pure":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert tnative.available()
    return request.param


def _save(ser, obj, compr):
    if isinstance(obj, (jser.SerializableCiphertext, jser.SerializableKSwitchKeys,
                        tser.SerializableCiphertext, tser.SerializableKSwitchKeys)):
        return obj.save(compr)
    return ser.save(obj, compr)


def _u64(x):
    return to_numpy(x) if hasattr(x, "numel") else np.asarray(x, dtype=np.uint64)


@pytest.mark.parametrize("compr", COMPR)
@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_save_is_byte_identical(scheme, compr, host_route, bfv, ckks):
    ring = bfv if scheme == "BFV" else ckks
    for name, jobj, tobj in ring.pairs():
        want = _save(jser, jobj, compr)
        assert _save(tser, tobj, compr) == want, name
        if compr == tser.COMPR_NONE:
            assert tser.save_size(tobj) == len(want) == jser.save_size(jobj), name
        else:
            assert tser.save_size(tobj, compr) == jser.save_size(jobj, compr) >= len(want), name


def _kswitch_arrays(keys):
    return [[_u64(pk.data.data) for pk in row] for row in keys.keys]


@pytest.mark.parametrize("compr", COMPR)
def test_cross_loading(compr, bfv, ckks):
    for ring in (bfv, ckks):
        for blob in (jser.save(ring.jct, compr), tser.save(ring.ct, compr),
                     J.SerializableCiphertext(ring.jct, SEED).save(compr)):
            j, t = jser.load_ciphertext(blob, ring.jc), tser.load_ciphertext(blob, ring.tc)
            np.testing.assert_array_equal(np.asarray(j.data), _u64(t.data))
            assert (j.parms_id, j.is_ntt_form, j.scale) == (t.parms_id, t.is_ntt_form, t.scale)
            assert t.data.device.type == "cpu"
        blob = tser.save(ring.ct, compr)
        np.testing.assert_array_equal(np.asarray(jser.load_ciphertext(blob, ring.jc).data),
                                      _u64(ring.ct.data))
        for jload, tload, obj in ((jser.load_relin_keys, tser.load_relin_keys, ring.rk),
                                  (jser.load_galois_keys, tser.load_galois_keys, ring.gk)):
            blob = tser.save(obj, compr)
            j, t = jload(blob, ring.jc), tload(blob, ring.tc)
            assert type(t).__name__ == type(j).__name__ and t.parms_id == j.parms_id
            for jrow, trow in zip(_kswitch_arrays(j), _kswitch_arrays(t)):
                assert len(jrow) == len(trow)
                for a, b in zip(jrow, trow):
                    np.testing.assert_array_equal(a, b)
        blob = jser.save(ring.jkg.secret_key, compr)
        np.testing.assert_array_equal(_u64(tser.load_secret_key(blob, ring.tc).data),
                                      np.asarray(ring.jkg.secret_key.data))
        blob = jser.save(ring.jkg.public_key(), compr)
        np.testing.assert_array_equal(_u64(tser.load_public_key(blob, ring.tc).data.data),
                                      np.asarray(ring.jkg.public_key().data.data))
        blob = jser.save(ring.jpt, compr)
        j, t = jser.load_plaintext(blob, ring.jc), tser.load_plaintext(blob, ring.tc)
        np.testing.assert_array_equal(np.asarray(j.data), _u64(t.data))
        assert (j.parms_id, j.scale) == (t.parms_id, t.scale)
        for blob in (jser.save(ring.jparms, compr), tser.save(ring.tparms, compr)):
            assert tser.load_parms(blob).parms_id == jser.load_parms(blob).parms_id
        assert tser.load_modulus(jser.save(ring.jparms.coeff_modulus[0])).value == \
            ring.jparms.coeff_modulus[0].value
    # a loader without a context puts the data where it is asked
    assert tser.load_ciphertext(jser.save(bfv.jct), device="cpu").data.device.type == "cpu"


def _outcome(load, blob):
    """What a loader makes of a blob: the error's type name, or the loaded
    object's arrays and metadata."""
    try:
        obj = load(blob)
    except LOAD_ERRORS as e:
        return type(e).__name__
    if hasattr(obj, "keys") and isinstance(obj.keys, list):
        return ("keys", obj.parms_id, [[(a.tobytes(), pk.data.is_ntt_form)
                                        for a, pk in zip(arow, row)]
                                       for arow, row in zip(_kswitch_arrays(obj), obj.keys)])
    if hasattr(obj, "poly_modulus_degree") and hasattr(obj, "coeff_modulus"):
        return ("parms", obj.parms_id)
    return ("ciphertext", obj.parms_id, obj.is_ntt_form, struct.pack("<d", obj.scale),
            _u64(obj.data).tobytes())


def _fuzz_same(jload, tload, blob, rng):
    """The JAX test's corpus (24 byte flips, truncations at region
    boundaries, random garbage): both loaders accept or reject alike, and
    what both accept is equal."""
    corpus = []
    for off in sorted(rng.choice(len(blob), size=24, replace=False)):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        corpus.append(bytes(bad))
    corpus += [blob[:cut] for cut in [0, 1, 7, 15, 16, 17, len(blob) // 2, len(blob) - 1]]
    corpus += [rng.bytes(size) for size in (0, 16, 256)]
    for i, bad in enumerate(corpus):
        assert _outcome(tload, bad) == _outcome(jload, bad), i
    for bad in corpus[24:]:
        assert isinstance(_outcome(tload, bad), str)   # truncated or garbage: rejected


def test_loaders_reject_corruption_alike(bfv, ckks):
    """tests/test_serialization.py:640 and :724 through both packages."""
    rng = np.random.default_rng(99)
    for compr in COMPR:
        _fuzz_same(lambda b: jser.load_ciphertext(b, ckks.jc),
                   lambda b: tser.load_ciphertext(b, ckks.tc), tser.save(ckks.ct, compr), rng)
    rng = np.random.default_rng(7)
    _fuzz_same(lambda b: jser.load_relin_keys(b, bfv.jc),
               lambda b: tser.load_relin_keys(b, bfv.tc), tser.save(bfv.rk), rng)
    _fuzz_same(lambda b: jser.load_galois_keys(b, bfv.jc),
               lambda b: tser.load_galois_keys(b, bfv.tc), tser.save(bfv.gk), rng)
    _fuzz_same(jser.load_parms, tser.load_parms, tser.save(bfv.tparms), rng)
    enc = T.Encryptor(bfv.tc, secret_key=bfv.sk, device="cpu")
    sct_blob = enc.encrypt_symmetric_serializable(T.Plaintext.from_hex("2x^1 + 1",
                                                                       device="cpu")).save()
    _fuzz_same(lambda b: jser.load_ciphertext(b, bfv.jc),
               lambda b: tser.load_ciphertext(b, bfv.tc), sct_blob, rng)
    srk_blob = tser.SerializableKSwitchKeys(bfv.rk, [[SEED] * len(bfv.rk.keys[0])]).save()
    _fuzz_same(lambda b: jser.load_relin_keys(b, bfv.jc),
               lambda b: tser.load_relin_keys(b, bfv.tc), srk_blob, rng)


def test_seal34_legacy_header_loads(bfv):
    """tests/test_serialization.py:449 through both packages."""
    payload = tser.save(bfv.ct)[16:]
    z = zlib.compress(payload)
    blobs = [struct.pack("<HBBIQ", 0xA15E, 0, 0, 16 + len(payload), 0) + payload,
             struct.pack("<HBBIQ", 0xA15E, 0, 1, 16 + len(z), 0) + z]
    for blob in blobs:
        np.testing.assert_array_equal(_u64(tser.load_ciphertext(blob, bfv.tc).data),
                                      _u64(bfv.ct.data))
        assert _outcome(lambda b: tser.load_ciphertext(b, bfv.tc), blob) == \
            _outcome(lambda b: jser.load_ciphertext(b, bfv.jc), blob)
    dec = T.Decryptor(bfv.tc, bfv.sk, device="cpu")
    assert dec.decrypt(tser.load_ciphertext(blobs[0], bfv.tc)).to_hex() == "5x^3 + 4x + 3"
    bad = struct.pack("<HBBBBHQ", 0xBEEF, 16, 3, 5, 0, 0, 16) + payload
    for load in (lambda b: tser.load_ciphertext(b, bfv.tc),
                 lambda b: jser.load_ciphertext(b, bfv.jc)):
        with pytest.raises(ValueError):
            load(bad)
    bad = struct.pack("<HBBIQ", 0xA15E, 0, 2, 16 + len(payload), 0) + payload
    assert _outcome(lambda b: tser.load_ciphertext(b, bfv.tc), bad) == \
        _outcome(lambda b: jser.load_ciphertext(b, bfv.jc), bad) == "ValueError"


def test_streams_and_truncation(bfv):
    """tests/test_serialization.py:574 and :608 through both packages: one
    stream of several objects reads back object by object in either
    package, and a truncated stream is rejected by both."""
    buf = io.BytesIO()
    sizes = [tser.save_to(bfv.tparms, buf), tser.save_to(bfv.ct, buf, tser.COMPR_DEFLATE),
             tser.save_to(bfv.rk, buf)]
    buf.write(b"TRAILING")
    assert sizes[0] == tser.save_size(bfv.tparms)
    data = buf.getvalue()
    for ser, ctx in ((tser, bfv.tc), (jser, bfv.jc)):
        s = io.BytesIO(data)
        assert ser.load_parms_from(s).parms_id == bfv.tparms.parms_id
        np.testing.assert_array_equal(_u64(ser.load_ciphertext_from(s, ctx).data),
                                      _u64(bfv.ct.data))
        rk = ser.load_relin_keys_from(s, ctx)
        np.testing.assert_array_equal(_kswitch_arrays(rk)[0][0], _kswitch_arrays(bfv.rk)[0][0])
        assert s.read() == b"TRAILING"
    blob = tser.save(bfv.tparms)
    for ser in (tser, jser):
        for cut in (blob[:10], blob[:-4]):
            with pytest.raises(ValueError, match="invalid"):
                ser.read_framed(io.BytesIO(cut))
    enc = T.Encryptor(bfv.tc, secret_key=bfv.sk, device="cpu")
    sct = enc.encrypt_symmetric_serializable(T.Plaintext.from_hex("2x^1 + 1", device="cpu"))
    buf = io.BytesIO()
    assert tser.save_to(sct, buf) == len(sct.save()) == tser.save_size(sct)
    assert buf.getvalue() == sct.save()


def _with_residue(blob, ring, index, value):
    """A ciphertext blob whose u64 residue `index` of its data is `value`."""
    arr = _u64(ring.ct.data).copy().reshape(-1)
    data_off = len(blob) - 8 * arr.size
    assert blob[data_off:] == arr.astype("<u8").tobytes()
    arr[index] = value
    return blob[:data_off] + arr.astype("<u8").tobytes()


def test_residues_out_of_range_rejected(bfv):
    blob = tser.save(bfv.ct)
    n = 64
    p1 = bfv.tparms.coeff_modulus[1].value
    for index, value in ((n + 5, p1), (3, (1 << 63) | 5), (2 * n * 2 - 1, (1 << 64) - 1)):
        bad = _with_residue(blob, bfv, index, value)
        for load in (lambda b: tser.load_ciphertext(b, bfv.tc),
                     lambda b: jser.load_ciphertext(b, bfv.jc)):
            with pytest.raises(ValueError, match="residues out of bounds"):
                load(bad)
        # unchecked, the object loads; valcheck rejects it in both packages
        t = tser.load_ciphertext(bad, bfv.tc, validate=False)
        j = jser.load_ciphertext(bad, bfv.jc, validate=False)
        assert not tvalcheck.is_data_valid_for(t, bfv.tc)
        assert not tvalcheck.is_valid_for(t, bfv.tc)
        assert not jvalcheck.is_data_valid_for(j, bfv.jc)
    assert tvalcheck.is_valid_for(tser.load_ciphertext(blob, bfv.tc), bfv.tc)
    # a residue with bit 63 set in a key: rejected by both key loaders
    rk_blob = tser.save(bfv.rk)
    arr = _kswitch_arrays(bfv.rk)[0][0].reshape(-1)
    raw = arr.astype("<u8").tobytes()
    off = rk_blob.index(raw)
    bad = rk_blob[:off + 8] + struct.pack("<Q", (1 << 63) | int(arr[1])) + rk_blob[off + 16:]
    for load in (lambda b: tser.load_relin_keys(b, bfv.tc),
                 lambda b: jser.load_relin_keys(b, bfv.jc)):
        with pytest.raises(ValueError, match="residues out of bounds"):
            load(bad)


@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_seeded_encryption_is_byte_identical(scheme, bfv, ckks):
    """Pinned-seed symmetric and seed-compressed encryption in fresh
    contexts of both packages (the seed counter is per context)."""
    ring = bfv if scheme == "BFV" else ckks
    jc = J.SealContext(_parms(J, scheme), sec_level=J.SecLevelType.none)
    tc = T.SealContext(_parms(T, scheme), sec_level=T.SecLevelType.none, device="cpu")
    jenc = J.Encryptor(jc, secret_key=ring.jkg.secret_key)
    tenc = T.Encryptor(tc, secret_key=secret_key_from_array(
        tc, np.asarray(ring.jkg.secret_key.data)), device="cpu")
    tpt = plaintext_from_array(tc, ring.jpt.data, ring.jpt.parms_id, ring.jpt.scale)
    assert tser.save(tenc.encrypt_symmetric(tpt)) == jser.save(jenc.encrypt_symmetric(ring.jpt))
    assert tser.save(tenc.encrypt_zero_symmetric()) == jser.save(jenc.encrypt_zero_symmetric())
    blobs = []
    for _ in range(2):
        a = tenc.encrypt_symmetric_serializable(tpt)
        b = jenc.encrypt_symmetric_serializable(ring.jpt)
        assert a.seed == b.seed and a.save() == b.save()
        np.testing.assert_array_equal(_u64(a.ct.data), np.asarray(b.ct.data))
        blobs.append(a.save())
        # the blob expands to the c1 the encryptor drew
        np.testing.assert_array_equal(_u64(tser.load_ciphertext(a.save(), tc).data),
                                      _u64(a.ct.data))
    assert blobs[0] != blobs[1]
    assert len(blobs[0]) < 0.6 * len(tser.save(tenc.encrypt_symmetric(tpt)))
    a, b = tenc.encrypt_zero_symmetric_serializable(), jenc.encrypt_zero_symmetric_serializable()
    assert a.save(tser.COMPR_DEFLATE) == b.save(jser.COMPR_DEFLATE)
    dec = T.Decryptor(tc, tenc.secret_key, device="cpu")
    got = dec.decrypt(tser.load_ciphertext(blobs[0], tc))
    want = J.Decryptor(jc, ring.jkg.secret_key).decrypt(jser.load_ciphertext(blobs[0], jc))
    np.testing.assert_array_equal(_u64(got.data), np.asarray(want.data))


def test_keygenerator_additions(bfv):
    """sk_power and the serializable relin and Galois keys, from the
    carried secret key in fresh pinned contexts of both packages."""
    jc = J.SealContext(_parms(J, "BFV"), sec_level=J.SecLevelType.none)
    tc = T.SealContext(_parms(T, "BFV"), sec_level=T.SecLevelType.none, device="cpu")
    jkg = J.KeyGenerator(jc, bfv.jkg.secret_key)
    tkg = T.KeyGenerator(tc, secret_key_from_array(tc, np.asarray(bfv.jkg.secret_key.data)),
                         device="cpu")
    for power in (3, 1, 2):
        np.testing.assert_array_equal(_u64(tkg.sk_power(power)), np.asarray(jkg.sk_power(power)))
    srk, jsrk = tkg.relin_keys_serializable(2), jkg.relin_keys_serializable(2)
    assert srk.seed_rows == jsrk.seed_rows
    assert srk.save() == jsrk.save() and tser.save(srk.obj) == jser.save(jsrk.obj)
    assert len(srk.save()) < 0.6 * len(tser.save(srk.obj))
    sgk, jsgk = tkg.galois_keys_serializable(bfv.elts), jkg.galois_keys_serializable(bfv.elts)
    assert sgk.save(tser.COMPR_DEFLATE) == jsgk.save(jser.COMPR_DEFLATE)
    assert tser.save_size(sgk) == len(sgk.save()) == jser.save_size(jsgk)
    # the seeded blobs expand, in either package, to the expanded keys
    for blob, load, obj in ((srk.save(), tser.load_relin_keys, srk.obj),
                            (sgk.save(), tser.load_galois_keys, sgk.obj)):
        assert tser.save(load(blob, tc)) == tser.save(obj)
    assert jser.save(jser.load_galois_keys(sgk.save(), jc)) == tser.save(sgk.obj)
    # the unseeded keys after the seeded ones: the same in both
    assert tser.save(tkg.relin_keys()) == jser.save(jkg.relin_keys())


def ex6_flow(M, ser, **kw):
    """examples/ex6_serialization.py's client/server exchange at parms seed
    range(8): the blobs of the parameters and the ciphertext (deflate), the
    relin keys and the server's squared, relinearized and rescaled result,
    and the first two decoded slots."""
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(4096)
    parms.set_coeff_modulus(M.CoeffModulus.create(4096, [40, 30, 30]))
    parms.set_random_seed(tuple(range(8)))
    parms_blob = ser.save(parms, ser.COMPR_DEFLATE)
    client_parms = ser.load_parms(parms_blob)
    client_parms.set_random_seed(tuple(range(8)))
    ctx = M.SealContext(client_parms, **kw)
    kg = M.KeyGenerator(ctx, **kw)
    encoder = M.CKKSEncoder(ctx, **kw)
    enc = M.Encryptor(ctx, kg.public_key(), **kw)
    ct_blob = ser.save(enc.encrypt(encoder.encode([3.14, 2.718], 2.0 ** 30)), ser.COMPR_DEFLATE)
    rk_blob = ser.save(kg.relin_keys())
    sctx = M.SealContext(ser.load_parms(parms_blob), **kw)
    ev = M.Evaluator(sctx, **kw)
    result = ser.save(ev.rescale_to_next(ev.relinearize(
        ev.square(ser.load_ciphertext(ct_blob, sctx)), ser.load_relin_keys(rk_blob, sctx))))
    got = encoder.decode(M.Decryptor(ctx, kg.secret_key, **kw).decrypt(
        ser.load_ciphertext(result, ctx)))
    return [parms_blob, ct_blob, rk_blob, result], got[:2]


@pytest.mark.slow
def test_ex6_digests():
    """examples/ex6's flow in the JAX package: the sha256 digests and the
    decoded squares that chip_smoke.py expects of the port on the card; the
    port on the CPU makes the same blobs."""
    import hashlib

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    blobs, squares = ex6_flow(J, jser)
    keys = ("parms_deflate_sha256", "ciphertext_deflate_sha256", "relin_keys_sha256",
            "result_sha256")
    assert {k: hashlib.sha256(b).hexdigest() for k, b in zip(keys, blobs)} == chip_smoke.EX6
    assert squares == chip_smoke.EX6_SQUARES
    tblobs, tsquares = ex6_flow(T, tser, device="cpu")
    assert tblobs == blobs and tsquares == squares
