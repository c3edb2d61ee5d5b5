"""Serialization: the reference's exact wire format.

Port of gemini_seal_tpu/serialization.py (reference: native/src/seal/
serialization.{h,cpp}, serializable.h, ciphertext.cpp:170-290,
plaintext.cpp:204-280, kswitchkeys.cpp:43-150, encryptionparams.cpp:14-118,
modulus.cpp save/load, intarray.h:592-640).

Every object is framed by the 16-byte SEALHeader {magic 0xA15E, header_size
0x10, version 3.5, compr_mode, reserved, size} and optionally zlib-deflated
(compr_mode 1); a SEAL 3.4 header loads through the reference's upgrade
path.  Blobs are byte for byte the JAX package's and the reference's.
``save`` pulls tensors to the host as '<u8'; a deflate frame goes through
the native runtime's ``gst_frame`` when the host library is loaded, else
through ``zlib.compress`` (the same bytes).  The loaders read the wire into
host np.uint64 arrays, expand seeded ciphertexts (c1 from
``Blake2xbPRNG(seed)``), check the metadata and every residue bound there
(valcheck), and only then place the data on the context's device; with no
context, on ``device`` (None means the card, and raises without one).
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from .ciphertext import Ciphertext, Plaintext
from .keys import GaloisKeys, KSwitchKeys, PublicKey, RelinKeys, SecretKey
from .modulus import Modulus
from .ops.backend import host_u64, resolve_device, to_tensor
from .params import PARMS_ID_ZERO, EncryptionParameters, SchemeType
from .utils import native
from .utils.blake2 import Blake2xbPRNG
from .valcheck import _numel, is_data_valid_for, is_metadata_valid_for
from .utils.prng import sample_poly_uniform

__all__ = [
    "SerializableCiphertext",
    "SerializableKSwitchKeys",
    "COMPR_NONE",
    "COMPR_DEFLATE",
    "save",
    "load_parms",
    "load_modulus",
    "load_plaintext",
    "load_ciphertext",
    "load_secret_key",
    "load_public_key",
    "load_kswitch_keys",
    "load_relin_keys",
    "load_galois_keys",
    "save_size",
    "save_to",
    "read_framed",
    "load_ciphertext_from",
    "load_plaintext_from",
    "load_secret_key_from",
    "load_public_key_from",
    "load_relin_keys_from",
    "load_galois_keys_from",
    "load_parms_from",
]

SEAL_MAGIC = 0xA15E
HEADER_SIZE = 0x10
VERSION_MAJOR = 3
VERSION_MINOR = 5
COMPR_NONE = 0
COMPR_DEFLATE = 1

_HEADER_FMT = "<HBBBBHQ"


def _frame(payload: bytes, compr_mode: int) -> bytes:
    # deflate frames through the native runtime when it is loaded (header +
    # zlib, the same bytes); small uncompressed frames stay in Python, where
    # struct.pack and a concatenation beat the FFI round trip
    if compr_mode == COMPR_DEFLATE and native.available():
        framed = native.frame(payload, compr_mode)
        if framed is not None:
            return framed
    if compr_mode == COMPR_DEFLATE:
        payload = zlib.compress(payload)
    header = struct.pack(_HEADER_FMT, SEAL_MAGIC, HEADER_SIZE, VERSION_MAJOR, VERSION_MINOR,
                         compr_mode, 0, HEADER_SIZE + len(payload))
    return header + payload


def _unframe(data: bytes, offset: int = 0):
    """Returns (payload_bytes, total_size)."""
    if len(data) < offset + HEADER_SIZE:
        raise ValueError("loaded SEALHeader is invalid (truncated stream)")
    magic, hsize, _vmaj, _vmin, compr, _res, size = struct.unpack_from(_HEADER_FMT, data, offset)
    if magic != SEAL_MAGIC:
        raise ValueError("loaded SEALHeader is invalid (bad magic)")
    if hsize != HEADER_SIZE:
        if hsize == 0:
            # SEAL 3.4 header {magic u16, zero u8, compr u8, size u32, reserved
            # u64}, the same 16 bytes: upgraded as the reference's
            # LoadHeader(try_upgrade_if_invalid) does (serialization.cpp:137-165)
            _m, _z, compr, size, _res = struct.unpack_from("<HBBIQ", data, offset)
            if compr not in (COMPR_NONE, COMPR_DEFLATE):
                raise ValueError("unsupported compression mode (legacy header)")
            if compr == COMPR_DEFLATE:
                payload = zlib.decompress(data[offset + HEADER_SIZE: offset + size])
            else:
                payload = data[offset + HEADER_SIZE:]
            return payload, size
        raise ValueError("loaded SEALHeader is invalid (bad header size)")
    if compr == COMPR_DEFLATE:
        payload = zlib.decompress(data[offset + HEADER_SIZE: offset + size])
    elif compr == COMPR_NONE:
        # stream semantics, like the reference's Load: the reader consumes
        # exactly the fields it needs from the whole remainder (the size field
        # is not trusted for slicing; the fork's parms save_size under-reports)
        payload = data[offset + HEADER_SIZE:]
    else:
        raise ValueError("unsupported compression mode")
    return payload, size


def _u64s(arr) -> bytes:
    return np.ascontiguousarray(host_u64(arr), dtype="<u8").tobytes()


def _int_array_save(arr) -> bytes:
    """IntArray wire format: inner SEALHeader + u64 count + raw u64 data."""
    flat = host_u64(arr).reshape(-1)
    return _frame(struct.pack("<Q", flat.size) + _u64s(flat), COMPR_NONE)


def _int_array_load(data: bytes, offset: int):
    payload, size = _unframe(data, offset)
    (count,) = struct.unpack_from("<Q", payload, 0)
    arr = np.frombuffer(payload, dtype="<u8", count=count, offset=8).astype(np.uint64)
    return arr, offset + size


def _clean_loader(fn):
    """A payload truncated mid-field makes struct.unpack_from raise
    struct.error, which is not of the ValueError family that callers are
    promised: normalized at the API boundary."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except struct.error as e:
            raise ValueError(f"loaded object payload is invalid: {e}") from e

    return wrapped


# ---------------------------------------------------------------------------
# per-object payloads
# ---------------------------------------------------------------------------

def _modulus_payload(m: Modulus) -> bytes:
    return struct.pack("<Q", m.value)


def _parms_payload(parms: EncryptionParameters) -> bytes:
    out = struct.pack("<B", int(parms.scheme))
    out += struct.pack("<Q", parms.poly_modulus_degree)
    out += struct.pack("<Q", parms.n_special_primes)
    out += struct.pack("<Q", len(parms.coeff_modulus))
    for m in parms.coeff_modulus:
        out += _frame(_modulus_payload(m), COMPR_NONE)
    out += _frame(_modulus_payload(parms.plain_modulus), COMPR_NONE)
    return out


def _plaintext_payload(parms_id, data, scale: float) -> bytes:
    data = host_u64(data)
    out = _u64s(np.array(parms_id, dtype=np.uint64))
    out += struct.pack("<Q", data.size)
    out += struct.pack("<d", scale)
    out += _int_array_save(data)
    return out


def _ciphertext_payload(c: Ciphertext) -> bytes:
    """The members of one ciphertext (its data a tensor or a host u64
    array): the payload of its blob, or of a key-switch key's bundle."""
    data, parms_id, is_ntt_form, scale = host_u64(c.data), c.parms_id, c.is_ntt_form, c.scale
    size, L, degree = data.shape
    out = _u64s(np.array(parms_id, dtype=np.uint64))
    out += struct.pack("<B", 1 if is_ntt_form else 0)
    out += struct.pack("<QQQ", size, degree, L)
    out += struct.pack("<d", scale)
    out += _int_array_save(data)
    return out


def _kswitch_payload(k: KSwitchKeys) -> bytes:
    out = _u64s(np.array(k.parms_id, dtype=np.uint64))
    out += struct.pack("<Q", len(k.keys))
    for row in k.keys:
        out += struct.pack("<Q", len(row))
        for pk in row:
            out += _frame(_ciphertext_payload(pk.data), COMPR_NONE)
    return out


def save(obj, compr_mode: int = COMPR_NONE) -> bytes:
    """Serialize any of the port's objects to the reference wire format."""
    if isinstance(obj, EncryptionParameters):
        payload = _parms_payload(obj)
    elif isinstance(obj, Modulus):
        payload = _modulus_payload(obj)
    elif isinstance(obj, SecretKey):
        # SecretKey.save is the wrapped Plaintext.save (secretkey.h)
        payload = _plaintext_payload(obj.parms_id, obj.data, 1.0)
    elif isinstance(obj, PublicKey):
        payload = _ciphertext_payload(obj.data)
    elif isinstance(obj, Plaintext):
        payload = _plaintext_payload(obj.parms_id, obj.data, obj.scale)
    elif isinstance(obj, Ciphertext):
        payload = _ciphertext_payload(obj)
    elif isinstance(obj, KSwitchKeys):
        payload = _kswitch_payload(obj)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")
    return _frame(payload, compr_mode)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def _device_of(context, device):
    """Where a loader places its data: the context's device (``device``, if
    given, must be it), or without a context ``device`` (None: the card)."""
    if context is None:
        return resolve_device(device)
    return context.device if device is None else context.check_device(device)


@_clean_loader
def load_modulus(data: bytes) -> Modulus:
    payload, _ = _unframe(data)
    (v,) = struct.unpack_from("<Q", payload, 0)
    return Modulus(v)


@_clean_loader
def load_parms(data: bytes) -> EncryptionParameters:
    payload, _ = _unframe(data)
    pos = 0
    (scheme,) = struct.unpack_from("<B", payload, pos)
    pos += 1
    (degree,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    (nsp,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    if nsp < 1:
        raise ValueError("EncryptionParameters: n_special_primes is invalid")
    (count,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    mods = []
    for _ in range(count):
        inner, size = _unframe(payload, pos)
        (v,) = struct.unpack_from("<Q", inner, 0)
        mods.append(Modulus(v))
        pos += size
    inner, size = _unframe(payload, pos)
    (t,) = struct.unpack_from("<Q", inner, 0)

    parms = EncryptionParameters(SchemeType(scheme))
    if degree:
        parms.set_poly_modulus_degree(degree)
    if mods:
        parms.set_coeff_modulus(mods)
    if t:
        parms.set_plain_modulus(t)
    parms.set_n_special_primes(nsp)
    return parms


def _parms_id_at(payload: bytes, pos: int):
    return tuple(int(v) for v in np.frombuffer(payload, dtype="<u8", count=4, offset=pos))


def _plaintext_from(payload: bytes):
    parms_id = _parms_id_at(payload, 0)
    (coeff_count,) = struct.unpack_from("<Q", payload, 32)
    (scale,) = struct.unpack_from("<d", payload, 40)
    arr, pos = _int_array_load(payload, 48)
    return parms_id, coeff_count, scale, arr, pos


def _host_plaintext(data: bytes, context):
    """(parms_id, scale, host u64 data) of a plaintext blob."""
    payload, _ = _unframe(data)
    parms_id, _count, scale, arr, _ = _plaintext_from(payload)
    if parms_id != PARMS_ID_ZERO and context is not None:
        cd = context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("plaintext parms_id is not valid for the context")
        arr = arr.reshape(len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree)
    return parms_id, scale, arr


@_clean_loader
def load_plaintext(data: bytes, context=None, device=None) -> Plaintext:
    parms_id, scale, arr = _host_plaintext(data, context)
    return Plaintext(data=to_tensor(arr, _device_of(context, device)), parms_id=parms_id,
                     scale=scale)


def _ciphertext_from(payload: bytes, context) -> Ciphertext:
    """A ciphertext's members -> a Ciphertext holding host u64 data (a
    seeded one expanded: c1 drawn from its seed)."""
    parms_id = _parms_id_at(payload, 0)
    pos = 32
    (is_ntt,) = struct.unpack_from("<B", payload, pos)
    pos += 1
    size, degree, L = struct.unpack_from("<QQQ", payload, pos)
    pos += 24
    (scale,) = struct.unpack_from("<d", payload, pos)
    pos += 8
    arr, pos = _int_array_load(payload, pos)

    cd = None
    if context is not None:
        cd = context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("ciphertext parms_id is not valid for the context")
        if degree != cd.parms.poly_modulus_degree or L != len(cd.parms.coeff_modulus):
            raise ValueError("ciphertext metadata mismatch")

    if arr.size == size * L * degree:
        data = np.ascontiguousarray(arr.reshape(size, L, degree))
    elif arr.size == (size // 2 + size % 2) * L * degree or arr.size == L * degree:
        # seeded ciphertext: c0 and the 64-byte c1 seed (ciphertext.cpp:189-209);
        # c1 is the uniform sample in the ciphertext's own domain
        if cd is None:
            raise ValueError("loading a seeded ciphertext requires a context")
        seed = np.frombuffer(payload, dtype="<u8", count=8, offset=pos)
        c1 = sample_poly_uniform(Blake2xbPRNG(tuple(int(s) for s in seed)),
                                 cd.parms.coeff_modulus, degree)
        data = np.concatenate([arr.reshape(-1, L, degree), c1[None]], axis=0)
    else:
        raise ValueError("ciphertext data size mismatch")
    return Ciphertext(data=data, parms_id=parms_id, is_ntt_form=bool(is_ntt), scale=scale)


def _validate_loaded(obj, context, what: str, metadata: bool = True):
    """Serialization is the trust boundary: the reference's checked load
    (valcheck.cpp is_valid_for after unsafe_load), the metadata (not for a
    secret key, as in the JAX package) and the per-limb residue bounds, here
    on the host data before it is uploaded."""
    if metadata and not is_metadata_valid_for(obj, context):
        raise ValueError(f"loaded {what} metadata is invalid for the context")
    if not is_data_valid_for(obj, context):
        raise ValueError(f"loaded {what} data is invalid for the context "
                         "(residues out of bounds)")


def _upload_ciphertext(ct: Ciphertext, device) -> Ciphertext:
    return Ciphertext(to_tensor(ct.data, device), ct.parms_id, ct.is_ntt_form, ct.scale)


def load_ciphertext_host(data: bytes, context, validate: bool = True) -> Ciphertext:
    """A ciphertext blob -> a Ciphertext whose data is a host u64[size, L, N]
    array, expanded and checked as load_ciphertext does: the ingress of a
    server that stacks many of them before one upload."""
    payload, _ = _unframe(data)
    ct = _ciphertext_from(payload, context)
    if context is not None and validate:
        _validate_loaded(ct, context, "ciphertext")
    return ct


@_clean_loader
def load_ciphertext(data: bytes, context=None, validate: bool = True,
                    device=None) -> Ciphertext:
    return _upload_ciphertext(load_ciphertext_host(data, context, validate),
                              _device_of(context, device))


@_clean_loader
def load_secret_key(data: bytes, context=None, validate: bool = True,
                    device=None) -> SecretKey:
    parms_id, _scale, arr = _host_plaintext(data, context)
    sk = SecretKey(data=arr, parms_id=parms_id)
    if context is not None and validate:
        _validate_loaded(sk, context, "secret key", metadata=False)
    return SecretKey(data=to_tensor(arr, _device_of(context, device)), parms_id=parms_id)


@_clean_loader
def load_public_key(data: bytes, context=None, validate: bool = True,
                    device=None) -> PublicKey:
    payload, _ = _unframe(data)
    ct = _ciphertext_from(payload, context)
    pk = PublicKey(data=ct, parms_id=ct.parms_id)
    if context is not None and validate:
        _validate_loaded(pk, context, "public key")
    return PublicKey(data=_upload_ciphertext(ct, _device_of(context, device)),
                     parms_id=ct.parms_id)


def _load_kswitch_into(cls, data: bytes, context=None, validate: bool = True, device=None):
    payload, _ = _unframe(data)
    parms_id = _parms_id_at(payload, 0)
    pos = 32
    (dim1,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    keys = []
    for _ in range(dim1):
        (dim2,) = struct.unpack_from("<Q", payload, pos)
        pos += 8
        row = []
        for _ in range(dim2):
            inner, size = _unframe(payload, pos)
            ct = _ciphertext_from(inner, context)
            row.append(PublicKey(data=ct, parms_id=ct.parms_id))
            pos += size
        keys.append(row)
    obj = cls()
    obj.keys = keys
    obj.parms_id = parms_id
    if context is not None and validate:
        _validate_loaded(obj, context, "key-switch keys")
    dev = _device_of(context, device)
    for row in keys:
        for i, pk in enumerate(row):
            row[i] = PublicKey(data=_upload_ciphertext(pk.data, dev), parms_id=pk.parms_id)
    return obj


@_clean_loader
def load_kswitch_keys(data: bytes, context=None, validate: bool = True,
                      device=None) -> KSwitchKeys:
    return _load_kswitch_into(KSwitchKeys, data, context, validate, device)


@_clean_loader
def load_relin_keys(data: bytes, context=None, validate: bool = True,
                    device=None) -> RelinKeys:
    return _load_kswitch_into(RelinKeys, data, context, validate, device)


@_clean_loader
def load_galois_keys(data: bytes, context=None, validate: bool = True,
                     device=None) -> GaloisKeys:
    return _load_kswitch_into(GaloisKeys, data, context, validate, device)


# ---------------------------------------------------------------------------
# seed-compressed wrappers
# ---------------------------------------------------------------------------

class SerializableCiphertext:
    """Seed-compressed ciphertext wrapper (reference: serializable.h).

    Saves at roughly half size: the c0 polynomial and the 64-byte c1 seed
    (the ciphertext members with a half-size IntArray followed by the raw
    seed: Ciphertext::save_members' has_seed_marker branch,
    ciphertext.cpp:189-209).  load_ciphertext with a context expands it,
    drawing c1 from the seed again.
    """

    def __init__(self, ct: Ciphertext, seed):
        self.ct = ct
        self.seed = tuple(int(s) for s in seed)

    def save(self, compr_mode: int = COMPR_NONE) -> bytes:
        c = self.ct
        if c.size != 2:
            raise ValueError("seeded serialization needs a size-2 ciphertext")
        c0 = host_u64(c.data[0])
        payload = _u64s(np.asarray(c.parms_id, dtype=np.uint64))
        payload += struct.pack("<B", 1 if c.is_ntt_form else 0)
        payload += struct.pack("<QQQ", 2, c.poly_modulus_degree, c.coeff_modulus_size)
        payload += struct.pack("<d", c.scale)
        payload += _int_array_save(c0)
        payload += _u64s(np.asarray(self.seed, dtype=np.uint64))
        return _frame(payload, compr_mode)


class SerializableKSwitchKeys:
    """Seed-compressed key-switch keys (RelinKeys / GaloisKeys; reference:
    Serializable<RelinKeys>/<GaloisKeys>, keygenerator.h + serializable.h):
    every bundle ciphertext serializes as c0 and its 64-byte c1 seed, about
    half the wire size of the expanded keys.

    ``.obj`` is the expanded keys object, usable directly; the saved bytes
    load through load_relin_keys / load_galois_keys, which expand the seeded
    bundles.
    """

    def __init__(self, obj: KSwitchKeys, seed_rows):
        self.obj = obj
        self.seed_rows = seed_rows

    def save(self, compr_mode: int = COMPR_NONE) -> bytes:
        k = self.obj
        payload = _u64s(np.array(k.parms_id, dtype=np.uint64))
        payload += struct.pack("<Q", len(k.keys))
        for row, seeds in zip(k.keys, self.seed_rows):
            payload += struct.pack("<Q", len(row))
            for pk, seed in zip(row, seeds):
                payload += SerializableCiphertext(pk.data, seed).save(COMPR_NONE)
        return _frame(payload, compr_mode)


# ---------------------------------------------------------------------------
# bounded streams (reference: serialization.h:211-278, util/streambuf.h):
# save_size sizes a blob from metadata alone; save_to and read_framed work on
# file-like streams and never read past one framed object
# ---------------------------------------------------------------------------

def _deflate_bound(n: int) -> int:
    """zlib compressBound(n), the reference's bound for compr_mode deflate."""
    return n + (n >> 12) + (n >> 14) + (n >> 25) + 13


def _int_array_size(count: int) -> int:
    return HEADER_SIZE + 8 + 8 * count


def _payload_size(obj) -> int:
    """Exact payload size (before framing), from metadata only."""
    if isinstance(obj, SerializableCiphertext):
        # members + half-size IntArray (c0 only) + 64-byte seed
        c = obj.ct
        return 32 + 1 + 8 + 8 + 8 + 8 + _int_array_size(
            c.coeff_modulus_size * c.poly_modulus_degree) + 64
    if isinstance(obj, SerializableKSwitchKeys):
        total = 32 + 8
        for row, seeds in zip(obj.obj.keys, obj.seed_rows):
            total += 8
            for pk, _ in zip(row, seeds):
                total += HEADER_SIZE + _payload_size(SerializableCiphertext(pk.data, (0,) * 8))
        return total
    if isinstance(obj, Modulus):
        return 8
    if isinstance(obj, EncryptionParameters):
        return 1 + 8 + 8 + 8 + (len(obj.coeff_modulus) + 1) * (HEADER_SIZE + 8)
    if isinstance(obj, (SecretKey, Plaintext)):
        return 32 + 8 + 8 + _int_array_size(_numel(obj.data))
    if isinstance(obj, PublicKey):
        return _payload_size(obj.data)
    if isinstance(obj, Ciphertext):
        return 32 + 1 + 8 + 8 + 8 + 8 + _int_array_size(_numel(obj.data))
    if isinstance(obj, KSwitchKeys):
        total = 32 + 8
        for row in obj.keys:
            total += 8 + sum(HEADER_SIZE + _payload_size(pk.data) for pk in row)
        return total
    raise TypeError(f"cannot size {type(obj)}")


def save_size(obj, compr_mode: int = COMPR_NONE) -> int:
    """Bytes needed to save `obj`: exact for COMPR_NONE, an upper bound for
    COMPR_DEFLATE (reference: Serialization::ComprSizeEstimate)."""
    n = _payload_size(obj)
    if compr_mode == COMPR_NONE:
        return HEADER_SIZE + n
    if compr_mode == COMPR_DEFLATE:
        return HEADER_SIZE + _deflate_bound(n)
    raise ValueError("unsupported compression mode")


def save_to(obj, stream, compr_mode: int = COMPR_NONE) -> int:
    """Write one framed object to a file-like stream; returns the byte count
    (save_size for COMPR_NONE, at most it for deflate)."""
    if isinstance(obj, (SerializableCiphertext, SerializableKSwitchKeys)):
        blob = obj.save(compr_mode)
    else:
        blob = save(obj, compr_mode)
    stream.write(blob)
    return len(blob)


def read_framed(stream) -> bytes:
    """Read exactly one framed object from a stream (bounded by the
    SEALHeader's size field, never past the object)."""
    header = stream.read(HEADER_SIZE)
    if len(header) != HEADER_SIZE:
        raise ValueError("loaded SEALHeader is invalid")
    magic, hsize = struct.unpack_from("<HB", header, 0)
    if magic != SEAL_MAGIC or hsize != HEADER_SIZE:
        raise ValueError("loaded SEALHeader is invalid")
    (total,) = struct.unpack_from("<Q", header, 8)
    if total < HEADER_SIZE:
        raise ValueError("loaded SEALHeader is invalid")
    body = stream.read(total - HEADER_SIZE)
    if len(body) != total - HEADER_SIZE:
        raise ValueError("loaded SEALHeader is invalid")
    return header + body


def load_ciphertext_from(stream, context=None, validate: bool = True,
                         device=None) -> Ciphertext:
    return load_ciphertext(read_framed(stream), context, validate, device)


def load_plaintext_from(stream, context=None, device=None) -> Plaintext:
    return load_plaintext(read_framed(stream), context, device)


def load_secret_key_from(stream, context=None, validate: bool = True,
                         device=None) -> SecretKey:
    return load_secret_key(read_framed(stream), context, validate, device)


def load_public_key_from(stream, context=None, validate: bool = True,
                         device=None) -> PublicKey:
    return load_public_key(read_framed(stream), context, validate, device)


def load_relin_keys_from(stream, context=None, validate: bool = True,
                         device=None) -> RelinKeys:
    return load_relin_keys(read_framed(stream), context, validate, device)


def load_galois_keys_from(stream, context=None, validate: bool = True,
                          device=None) -> GaloisKeys:
    return load_galois_keys(read_framed(stream), context, validate, device)


def load_parms_from(stream) -> EncryptionParameters:
    return load_parms(read_framed(stream))
