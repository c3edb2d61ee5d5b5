"""The centred lift of CKKS bootstrapping's mod-raise (kernel ``mod_raise``).

Port of the middle of gemini_seal_tpu/models/bootstrap.py mod_raise
(bootstrap.py:261-264): a canonical residue c mod q0 is lifted to
(-q0/2, q0/2] and reduced against every prime of the top level.  The
inverse NTT before it and the forward NTT after it are the ``ntt`` kernel's
(models/bootstrap.py).  :func:`mod_raise_lift` is the wrapper: one launch
reads each coefficient once and writes its residues for all L primes
(csrc/mod_raise.cu); :func:`mod_raise_lift_plain` is its plain version.
"""

from __future__ import annotations

import torch

from . import cuda
from .backend import is_cuda
from .modops import barrett_reduce_64, reduce_once

__all__ = ["mod_raise_lift", "mod_raise_lift_plain"]


def mod_raise_lift_plain(x, p, ratio1, q0_mod_p, half: int):
    """Plain version of :func:`mod_raise_lift`."""
    L = p.numel()
    pc, r1, qm = (v.reshape(L, 1) for v in (p, ratio1, q0_mod_p))
    r = barrett_reduce_64(x, pc, r1)                      # [..., L, N]
    corr = reduce_once(r + (pc - qm), pc)
    return torch.where(x > half, corr, r)


def mod_raise_lift(x, p, ratio1, q0_mod_p, half: int):
    """out[..., l, n] = the centred lift of x[..., 0, n] reduced mod p_l.

    x: int64[..., 1, N] canonical residues mod q0 (the inverse NTT of the
    last level's one limb); p, ratio1, q0_mod_p: the L top-level primes, the
    high words of floor(2^128 / p) and q0 mod p (any shape of L elements);
    half = q0 >> 1.  Where x > half the value is negative: x - q0, whose
    residue is (x mod p + p - q0 mod p) mod p.  Returns int64[..., L, N].
    """
    if not is_cuda(x, p, ratio1, q0_mod_p):
        return mod_raise_lift_plain(x, p, ratio1, q0_mod_p, half)
    if x.dim() < 2 or x.shape[-2] != 1:
        raise ValueError(f"mod_raise: expected [..., 1, N], got {tuple(x.shape)}")
    L = p.numel()
    if ratio1.numel() != L or q0_mod_p.numel() != L or L < 1:
        raise ValueError("mod_raise: the constants do not match the primes")
    for t, what in ((x, "input"), (p, "primes"), (ratio1, "ratio1"), (q0_mod_p, "q0 mod p")):
        cuda.check(t, f"mod_raise {what}")
    N = x.shape[-1]
    out = torch.empty(x.shape[:-2] + (L, N), dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    cuda.call("mod_raise", cuda.ptr(out), cuda.ptr(x), cuda.ptr(p), cuda.ptr(ratio1),
              cuda.ptr(q0_mod_p), int(half), x.numel() // N, L, N)
    return out
