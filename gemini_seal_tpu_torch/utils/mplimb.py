"""Host-side multiprecision helpers for the exact CKKS decode.

Port of the parts of gemini_seal_tpu/utils/mplimb.py that the CKKS decode
ladder needs (reference: ckks.h:668-744).  CRT composition runs on Python
ints — exact, and the same integers as the JAX package's limb-plane
compose — and the result is split into base-2^64 limb planes for the
double ladder, whose operation order is the reference's.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["int_to_limbs", "ints_to_limbs", "compose_ints", "ladder_to_double"]

_MASK64 = (1 << 64) - 1


def int_to_limbs(x: int, nwords: int) -> np.ndarray:
    """Non-negative Python int -> uint64[nwords], least-significant first."""
    if x < 0:
        raise ValueError("int_to_limbs requires a non-negative value")
    out = np.zeros(nwords, dtype=np.uint64)
    for k in range(nwords):
        if not x:
            break
        out[k] = x & _MASK64
        x >>= 64
    if x:
        raise ValueError("value does not fit in nwords limbs")
    return out


def ints_to_limbs(values: List[int], nwords: int) -> np.ndarray:
    """[n] non-negative Python ints -> uint64[nwords, n] limb planes."""
    raw = b"".join(v.to_bytes(8 * nwords, "little") for v in values)
    return np.frombuffer(raw, dtype="<u8").reshape(len(values), nwords).T.astype(np.uint64)


def compose_ints(residues: np.ndarray, base) -> List[int]:
    """CRT-compose uint64[L, n] residue planes (residues[j] in [0, q_j))
    into the n integers v in [0, q) (rns.cpp:369-414)."""
    L, n = residues.shape
    if L != base.size:
        raise ValueError("residue plane count does not match the base")
    q = base.base_prod
    cols = [residues[j].tolist() for j in range(L)]
    terms = [(base[j].value, base.inv_punctured_prod_mod_base[j], base.punctured_prod[j])
             for j in range(L)]
    out = []
    for i in range(n):
        acc = 0
        for j, (qj, inv, punc) in enumerate(terms):
            acc += (cols[j][i] * inv % qj) * punc
        out.append(acc % q)
    return out


def ladder_to_double(limbs: np.ndarray, unit: float) -> np.ndarray:
    """sum_k float(limbs[k]) * (unit * 2^(64 k)) in LSB-first order — the
    reference decode ladder (ckks.h:700-741): same conversion rounding,
    same accumulation order."""
    k, n = limbs.shape
    acc = np.zeros(n, dtype=np.float64)
    scaled = float(unit)
    for idx in range(k):
        acc = acc + limbs[idx].astype(np.float64) * scaled
        scaled *= 18446744073709551616.0  # 2^64
    return acc
