"""ctypes bindings for the shared host runtime (native/gst_native.cpp).

The port builds the repository's shared C++ source with g++ into
``build/host/gst_native.so`` at first use and binds its host entry points:
the BLAKE2 stream of the samplers (``gst_prng_fill``, ``gst_blake2xb``), the
SEALHeader framing with zlib deflate (``gst_frame_bound``, ``gst_frame``,
``gst_unframe``), and the exact CKKS host arithmetic: CRT composition into
limb planes (``gst_crt_compose``), the fused compose + centred lift + double
ladder of the decode (``gst_crt_centered_double``) and the RNS
decomposition of rounded doubles of any size (``gst_decompose_rounded``).
Every binding returns None when the library is absent; its callers then take
their pure route, which gives the same bytes, only slower (minutes for key
generation at N=8192).  The source's host NTTs are not bound: the port's
transforms run on the card (kernel ``ntt``) or, for CPU tensors, through
their plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "gst_native.cpp")
_LIB_PATH = os.path.join(_REPO, "build", "host", "gst_native.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "gst_prng_fill": (ctypes.c_int, [_P, _U64, _P, _U64]),
    "gst_blake2xb": (ctypes.c_int, [_P, _U64, _P, _U64, _P, _U64]),
    "gst_frame_bound": (ctypes.c_int64, [_U64]),
    "gst_frame": (ctypes.c_int64, [_P, ctypes.c_char_p, _U64, ctypes.c_int]),
    "gst_unframe": (ctypes.c_int64, [_P, _U64, ctypes.c_char_p, _U64]),
    "gst_crt_compose": (None, [_P, _P, _U64, _U64, _U64, _P, _P, _P, _P]),
    "gst_decompose_rounded": (None, [_P, _P, _U64, _U64, _P, _P, _U64]),
    "gst_crt_centered_double": (None, [_P, _P, _U64, _U64, _U64, _P, _P, _P, _P, _P,
                                       ctypes.c_double]),
}


def _build() -> None:
    """Compile the shared source; a failed build leaves the pure path."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-lz", "-o", tmp],
        capture_output=True, timeout=300,
    )
    if proc.returncode == 0:
        os.replace(tmp, _LIB_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SRC):
        return None
    stale = (os.path.exists(_LIB_PATH)
             and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))
    if not os.path.exists(_LIB_PATH) or stale:
        try:
            _build()
        except (OSError, subprocess.TimeoutExpired):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except (OSError, AttributeError):
        # an unreadable library, or a stale one that lacks a newer symbol
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def prng_fill(nblocks: int, seed, counter_start: int) -> Optional[bytes]:
    """nblocks consecutive 4096-byte BlakePRNG buffers."""
    lib = _load()
    if lib is None:
        return None
    nbytes = nblocks * 4096
    out = ctypes.create_string_buffer(nbytes)
    seed_arr = np.array(seed, dtype=np.uint64)
    rc = lib.gst_prng_fill(out, nbytes, _ptr(seed_arr), counter_start)
    if rc != 0:
        raise RuntimeError("gst_prng_fill failed")
    return out.raw


def blake2xb(out_len: int, data: bytes, key: bytes = b"") -> Optional[bytes]:
    """out_len bytes of BLAKE2Xb over data (keyed when key is given)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(out_len)
    rc = lib.gst_blake2xb(out, out_len, data, len(data), key if key else None, len(key))
    if rc != 0:
        raise RuntimeError("gst_blake2xb failed")
    return out.raw


def frame(payload: bytes, compr_mode: int) -> Optional[bytes]:
    """SEALHeader framing (+ deflate at zlib's default level), byte-identical
    to the Python route of serialization._frame."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(lib.gst_frame_bound(len(payload)))
    n = lib.gst_frame(out, payload, len(payload), compr_mode)
    if n < 0:
        raise RuntimeError("gst_frame failed")
    return out.raw[:n]


def unframe(data: bytes, out_cap_hint: int = 0) -> Optional[bytes]:
    """Check a 3.5 SEALHeader and inflate: the payload (for an uncompressed
    frame, the whole remainder of the stream)."""
    lib = _load()
    if lib is None:
        return None
    cap = max(out_cap_hint, 4 * len(data) + 1024)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.gst_unframe(out, cap, data, len(data))
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise ValueError("loaded SEALHeader is invalid")
        return out.raw[:n]


def crt_compose(residues: np.ndarray, inv_punc, mods, qhat, qprod,
                nwords: int) -> Optional[np.ndarray]:
    """[L, n] residues -> [nwords, n] limb planes of v in [0, q)."""
    lib = _load()
    if lib is None:
        return None
    residues = _u64(residues)
    L, n = residues.shape
    out = np.empty((nwords, n), dtype=np.uint64)
    lib.gst_crt_compose(_ptr(out), _ptr(residues), n, L, nwords, _ptr(_u64(inv_punc)),
                        _ptr(_u64(mods)), _ptr(_u64(qhat)), _ptr(_u64(qprod)))
    return out


def crt_centered_double(residues: np.ndarray, inv_punc, mods, qhat, qprod, upper,
                        nwords: int, inv_scale: float) -> Optional[np.ndarray]:
    """The CKKS decode ladder in one pass: [L, n] residues -> centred f64[n]
    (compose, lift v >= upper to -(q - v), LSB-first double ladder), bit for
    bit the limb-plane route of mplimb."""
    lib = _load()
    if lib is None:
        return None
    residues = _u64(residues)
    L, n = residues.shape
    out = np.empty(n, dtype=np.float64)
    lib.gst_crt_centered_double(_ptr(out), _ptr(residues), n, L, nwords,
                                _ptr(_u64(inv_punc)), _ptr(_u64(mods)), _ptr(_u64(qhat)),
                                _ptr(_u64(qprod)), _ptr(_u64(upper)), float(inv_scale))
    return out


def decompose_rounded(rounded: np.ndarray, mods, pow2: np.ndarray) -> Optional[np.ndarray]:
    """Exact RNS residues [L, n] of integer-valued doubles of any size;
    pow2[j, s] = 2^s mod mods[j] covers every exponent of the input."""
    lib = _load()
    if lib is None:
        return None
    rounded = np.ascontiguousarray(rounded, dtype=np.float64)
    pow2 = _u64(pow2)
    mods = _u64(mods)
    out = np.empty((mods.shape[0], rounded.shape[0]), dtype=np.uint64)
    lib.gst_decompose_rounded(_ptr(out), _ptr(rounded), rounded.shape[0], mods.shape[0],
                              _ptr(mods), _ptr(pow2), pow2.shape[1])
    return out
