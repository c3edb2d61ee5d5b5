"""The centred lift of CKKS bootstrapping's mod-raise (kernel ``mod_raise``).

Port of the middle of gemini_seal_tpu/models/bootstrap.py mod_raise
(bootstrap.py:261-264): a canonical residue c mod q0 is lifted to
(-q0/2, q0/2] and reduced against every prime of the top level.  The
inverse NTT before it and the forward NTT after it are the ``ntt`` kernel's
(models/bootstrap.py).  :func:`mod_raise_lift` is the wrapper: one launch
whose threads each read one coefficient once and write its residues for a
group of the L primes, the rows and tiles of a row on the grid's x axis and
the limb groups on y (csrc/mod_raise.cu, geometry :func:`mod_raise_geometry`);
the primes and their constants go by value in the launch's parameters
(:func:`mod_raise_constants`).  :func:`mod_raise_lift_plain` is its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda
from .backend import is_cuda
from .modops import _pow2_ceil, barrett_reduce_64, reduce_once

__all__ = ["mod_raise_lift", "mod_raise_lift_plain", "mod_raise_constants",
           "mod_raise_geometry", "MOD_RAISE_MAX_L"]

# primes a launch takes by value (csrc/mod_raise.cu MOD_RAISE_MAX_L): the
# most a chain may hold (modulus.py COEFF_MOD_COUNT_MAX)
MOD_RAISE_MAX_L = 64
_CTAS = 384             # CTAs a call aims at: about three an SM of the H100


def mod_raise_lift_plain(x, p, ratio1, q0_mod_p, half: int):
    """Plain version of :func:`mod_raise_lift`."""
    L = p.numel()
    pc, r1, qm = (v.reshape(L, 1) for v in (p, ratio1, q0_mod_p))
    r = barrett_reduce_64(x, pc, r1)                      # [..., L, N]
    corr = reduce_once(r + (pc - qm), pc)
    return torch.where(x > half, corr, r)


def mod_raise_constants(p, ratio1, q0_mod_p) -> np.ndarray:
    """The by-value constants of one launch, u64[3L]: the L primes, their
    r1 and p - q0 mod p (the kernel adds it where c is negative).  Raises
    ValueError above MOD_RAISE_MAX_L primes."""
    p, r1, qm = (np.asarray(v, dtype=np.uint64).reshape(-1) for v in (p, ratio1, q0_mod_p))
    L = p.size
    if not 1 <= L <= MOD_RAISE_MAX_L or r1.size != L or qm.size != L:
        raise ValueError(f"mod_raise: {L} primes with {r1.size} and {qm.size} constants "
                         f"(1 to {MOD_RAISE_MAX_L} primes, one constant each)")
    if not (qm < p).all():
        raise ValueError("mod_raise: q0 mod p must be below p")
    return np.concatenate([p, r1, p - qm])


def mod_raise_geometry(B: int, L: int, N: int) -> dict:
    """The launch geometry of one call, by shape: one thread a coefficient,
    a row's N coefficients on 2^``log_tiles`` CTAs of ``threads`` (128, or
    the row's width below it), each thread writing ``lpt`` limbs (grid y:
    ``groups``).  A call whose rows take fewer than _CTAS CTAs (about three
    an SM) splits its limbs into as many groups as it takes to reach them;
    a larger one takes three limbs a thread.  port_tools/small_kernels.py
    --sweep times the alternatives (64-256 threads, 1 to L limbs a thread):
    this pick is within 5% of the fastest at the refresh's shapes and at
    N=65536 with 64 primes."""
    threads = min(128, max(32, _pow2_ceil(N)))
    log_tiles = max(0, (N // threads).bit_length() - 1)
    per_group = B << log_tiles
    groups = min(L, -(-_CTAS // per_group)) if per_group < _CTAS else -(-L // 3)
    lpt = -(-L // groups)
    return {"threads": threads, "log_tiles": log_tiles, "lpt": lpt, "groups": -(-L // lpt)}


def mod_raise_lift(x, p, ratio1, q0_mod_p, half: int):
    """out[..., l, n] = the centred lift of x[..., 0, n] reduced mod p_l.

    x: int64[..., 1, N] canonical residues mod q0 (the inverse NTT of the
    last level's one limb); p, ratio1, q0_mod_p: the L top-level primes, the
    high words of floor(2^128 / p) and q0 mod p (any shape of L elements, at
    most MOD_RAISE_MAX_L); half = q0 >> 1.  Where x > half the value is
    negative: x - q0, whose residue is (x mod p + p - q0 mod p) mod p.
    Returns int64[..., L, N].  On the card the constants' values go by value
    into the launch: they are copied to the host at the first call with
    these tensors (``cuda.host_memo``).
    """
    if not is_cuda(x, p, ratio1, q0_mod_p):
        return mod_raise_lift_plain(x, p, ratio1, q0_mod_p, half)
    if x.dim() < 2 or x.shape[-2] != 1:
        raise ValueError(f"mod_raise: expected [..., 1, N], got {tuple(x.shape)}")
    L = p.numel()
    if ratio1.numel() != L or q0_mod_p.numel() != L or L < 1:
        raise ValueError("mod_raise: the constants do not match the primes")
    if L > MOD_RAISE_MAX_L:
        raise ValueError(f"mod_raise: {L} primes exceed the {MOD_RAISE_MAX_L} a launch takes")
    for t, what in ((x, "input"), (p, "primes"), (ratio1, "ratio1"), (q0_mod_p, "q0 mod p")):
        cuda.check(t, f"mod_raise {what}")
    N = x.shape[-1]
    out = torch.empty(x.shape[:-2] + (L, N), dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    if N & (N - 1):
        raise ValueError(f"mod_raise: N = {N} is not a power of two")
    if out.numel() >= 1 << 31:
        raise ValueError("mod_raise: the output exceeds 2^31 words (32-bit offsets)")
    consts = cuda.host_memo((p, ratio1, q0_mod_p), mod_raise_constants)
    B = x.numel() // N
    geo = mod_raise_geometry(B, L, N)
    cuda.call("mod_raise", cuda.ptr(out), cuda.ptr(x), consts.ctypes.data, int(half), B, L,
              N.bit_length() - 1, geo["threads"], geo["log_tiles"], geo["lpt"])
    return out
