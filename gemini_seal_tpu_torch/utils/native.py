"""ctypes bindings for the shared host runtime (native/gst_native.cpp).

The port builds the repository's shared C++ source with g++ into
``build/host/gst_native.so`` at first use and binds the one BLAKE2 entry
point the samplers need (``gst_prng_fill``).  When no toolchain is present the pure-Python
blake2xb path in :mod:`.blake2` gives the same bytes, only slower (minutes
for key generation at N=8192).
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
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gst_prng_fill.restype = ctypes.c_int
    lib.gst_prng_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def prng_fill(nblocks: int, seed, counter_start: int) -> Optional[bytes]:
    """nblocks consecutive 4096-byte BlakePRNG buffers."""
    lib = _load()
    if lib is None:
        return None
    nbytes = nblocks * 4096
    out = ctypes.create_string_buffer(nbytes)
    seed_arr = np.array(seed, dtype=np.uint64)
    rc = lib.gst_prng_fill(
        out, nbytes, seed_arr.ctypes.data_as(ctypes.c_void_p), counter_start
    )
    if rc != 0:
        raise RuntimeError("gst_prng_fill failed")
    return out.raw
