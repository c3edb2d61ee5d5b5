"""Build, load and launch the hand-written Hopper kernels.

Each ``csrc/*.cu`` source exports one C function that launches its kernel
on the stream it is given and returns ``cudaGetLastError()``.  The sources
are compiled with ``nvcc`` for ``sm_90a`` at first use, one process per
source started together, into ``build/kernels/`` under a name keyed by the
hash of the sources and flags, and bound with ``ctypes`` (``c_void_p`` for
every pointer and the stream).  A build or launch failure raises; nothing
falls back to the plain versions.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one right
after its kernel launched, and nowhere else.  A call in one of a kernel's
modes (``MODES``) also adds one under ``"kernel:mode"``, so that a check can
tell that the mode ran: the large-ring NTT, the signed, paired and signed
paired Galois permutations, the contraction with its input broadcast over
the groups and with both operands ciphertext data paired group by group,
the elementwise Barrett-64 reduction without a second operand,
the negacyclic shift with and without its monomial multiply, the NTT's
chunk-local stages of the coefficient-sharded NTT (``sub_row``) and the two
modes of its cross stages (``ntt_sp``: ``exchange``, ``rows``).  A call
runs in at most one mode.

``host_memo`` keeps host copies of the small constant tensors whose values
a kernel takes by value in its parameter struct (``mod_raise``,
``negacyclic``, ``infty_norm``, ``ntt_mxu``): each is copied from the device once, at its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Dict

import numpy as np
import torch

__all__ = ["KERNELS", "MODES", "LAUNCHES", "build", "call", "reset_launches",
           "BUILD_REPORT", "host_memo"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int64

# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "ntt": ("ntt.cu", "gst_ntt", [
        _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P]),
    "tensor_product": ("tensor_product.cu", "gst_tensor_product", [
        _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "contract": ("contract.cu", "gst_contract", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "elementwise": ("elementwise.cu", "gst_elementwise", [
        _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "galois": ("galois.cu", "gst_galois", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "behz": ("behz.cu", "gst_behz", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _P]),
    "scale_round": ("scale_round.cu", "gst_scale_round", [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "mod_raise": ("mod_raise.cu", "gst_mod_raise", [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "negacyclic": ("negacyclic.cu", "gst_negacyclic", [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "infty_norm": ("infty_norm.cu", "gst_infty_norm", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "ntt_sp": ("ntt_sp.cu", "gst_ntt_sp", [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    "ntt_mxu": ("ntt_mxu.cu", "gst_ntt_mxu", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}

# kernel name -> the modes that a call names (see ``call``)
MODES = {
    "ntt": ("large_ring", "sub_row"),
    "galois": ("signed", "paired", "signed_paired"),
    "contract": ("broadcast", "pairwise"),
    "elementwise": ("reduce64",),
    "negacyclic": ("shift", "mono_mul"),
    "ntt_sp": ("exchange", "rows"),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCHES.update({f"{k}:{m}": 0 for k, ms in MODES.items() for m in ms})

# name -> {"path", "seconds", "ptxas"} of the build that this process loaded
BUILD_REPORT: Dict[str, dict] = {}

_FUNCS: Dict[str, object] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == KERNELS[name][0] or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build() -> Dict[str, dict]:
    """Compile every kernel source that has no current build, in parallel.

    Returns BUILD_REPORT: per kernel its library path, build seconds (0 for
    a reused build) and the ``-Xptxas -v`` register/shared/spill summary.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (src, _, _) in KERNELS.items():
        if name in BUILD_REPORT:
            continue
        path = _lib_path(name)
        if os.path.exists(path):
            BUILD_REPORT[name] = {"path": path, "seconds": 0.0, "ptxas": "reused"}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}{out}")
            continue
        os.replace(tmp, path)
        ptxas = "\n".join(l for l in (err + out).splitlines()
                          if "registers" in l or "spill" in l or "smem" in l)
        BUILD_REPORT[name] = {"path": path,
                              "seconds": time.perf_counter() - t0,
                              "ptxas": ptxas}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return BUILD_REPORT


def _func(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        with _LOCK:
            if name not in BUILD_REPORT:
                build()
            _, entry, argtypes = KERNELS[name]
            lib = ctypes.CDLL(BUILD_REPORT[name]["path"])
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
    return fn


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 for None."""
    return 0 if t is None else t.data_ptr()


def call(name: str, *args, mode=None) -> None:
    """Launch kernel `name` on the current stream; raise on a CUDA error.

    mode: None, or the call's mode of MODES[name], counted beside the
    kernel's own count.  The counts are kept under a lock: the ranks of a
    parallel.comm.ThreadGroup launch from threads of one process."""
    fn = _func(name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if mode is not None:
            LAUNCHES[f"{name}:{mode}"] += 1


_HOST_MEMO: Dict[tuple, tuple] = {}


def host_memo(tensors, build):
    """build(*values) of small constant tensors (their u64 values as
    np.uint64 vectors), kept for as long as the same tensor objects live
    unmodified.  The first call copies the values from the device, which
    waits for the stream; later calls with the same tensors copy nothing.
    A kernel that takes its constants by value gets them here."""
    key = (build,) + tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    with _LOCK:
        hit = _HOST_MEMO.get(key)
        if (hit is not None and hit[1] == versions
                and all(r() is t for r, t in zip(hit[0], tensors))):
            return hit[2]
    out = build(*(t.detach().cpu().contiguous().reshape(-1).numpy().view(np.uint64)
                  for t in tensors))
    with _LOCK:
        for k in [k for k, h in _HOST_MEMO.items() if any(r() is None for r in h[0])]:
            del _HOST_MEMO[k]
        _HOST_MEMO[key] = (tuple(weakref.ref(t) for t in tensors), versions, out)
    return out


def check(t: torch.Tensor, what: str, dtype=torch.int64) -> None:
    """Wrapper-side checks shared by every kernel: CUDA, the dtype (int64
    residues, or the int8 digit planes of ``ntt_mxu``), contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
