"""Host-side multiprecision helpers for the exact CKKS decode.

Port of gemini_seal_tpu/utils/mplimb.py (reference: ckks.h:668-744,
rns.cpp:369-414).  A length-n array of K-word integers is a ``uint64[K, n]``
stack of base-2^64 limb planes.  CRT composition takes the native runtime's
``gst_crt_compose`` when the host library is loaded, and otherwise runs on
Python ints: both are exact, so both give the JAX package's limb planes.
The comparisons, subtractions and the double ladder are vectorized numpy
over the coefficient axis, in the reference's operation order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import native

__all__ = ["int_to_limbs", "ints_to_limbs", "limbs_to_ints", "compose_ints", "compose_limbs",
           "native_compose_consts", "geq_limbs", "sub_limbs_masked", "sub_from_limbs",
           "ladder_to_double"]

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


def limbs_to_ints(limbs: np.ndarray) -> List[int]:
    """uint64[K, n] limb planes -> [n] Python ints (one bytes pass)."""
    k, n = limbs.shape
    raw = np.ascontiguousarray(limbs.T.astype("<u8")).tobytes()
    step = 8 * k
    return [int.from_bytes(raw[i * step: (i + 1) * step], "little") for i in range(n)]


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


def native_compose_consts(base, K: int):
    """(K, inv_punc, mods, qhat, qprod): the constants of the native CRT
    routines (gst_crt_compose, gst_crt_centered_double), built once per
    RNSBase and word count."""
    consts = base.__dict__.get("_compose_native_consts")
    if consts is None or consts[0] != K:
        qhat = np.stack([int_to_limbs(base.punctured_prod[j], K) for j in range(base.size)])
        consts = (K, np.asarray(base.inv_punctured_prod_mod_base, dtype=np.uint64),
                  np.asarray(base.values(), dtype=np.uint64), qhat,
                  int_to_limbs(base.base_prod, K + 1))
        base._compose_native_consts = consts
    return consts


def compose_limbs(residues: np.ndarray, base, nwords: Optional[int] = None) -> np.ndarray:
    """CRT-compose uint64[L, n] residue planes into uint64[K, n] limb planes
    of the unique v in [0, q) (rns.cpp:369-414 RNSBase::compose)."""
    L, n = residues.shape
    if L != base.size:
        raise ValueError("residue plane count does not match the base")
    q = base.base_prod
    K = nwords if nwords is not None else max(1, (q.bit_length() + 63) // 64)
    consts = native_compose_consts(base, K) if native.available() else None
    if consts is not None:
        out = native.crt_compose(residues, consts[1], consts[2], consts[3], consts[4], K)
        if out is not None:
            return out
    return ints_to_limbs(compose_ints(np.asarray(residues, dtype=np.uint64), base), K)


def geq_limbs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized multi-limb a >= b (most-significant word first)."""
    k = a.shape[0]
    decided = np.zeros(a.shape[1:], dtype=bool)
    result = np.ones(a.shape[1:], dtype=bool)  # equal -> True (>=)
    for idx in range(k - 1, -1, -1):
        aw, bw = a[idx], np.broadcast_to(b[idx], a[idx].shape)
        gt = aw > bw
        lt = aw < bw
        result = np.where(~decided & gt, True, result)
        result = np.where(~decided & lt, False, result)
        decided |= gt | lt
    return result


def sub_limbs_masked(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> None:
    """In place a -= b where mask (a >= b there); vector borrows."""
    borrow = np.zeros(a.shape[1:], dtype=np.uint64)
    m64 = mask.astype(np.uint64)
    for idx in range(a.shape[0]):
        bw = np.broadcast_to(b[idx], a[idx].shape) * m64  # 0 where unmasked
        d1 = a[idx] - bw
        brw1 = (a[idx] < bw).astype(np.uint64)
        d2 = d1 - borrow
        brw2 = (d1 < borrow).astype(np.uint64)
        a[idx] = d2
        borrow = brw1 + brw2


def sub_from_limbs(minuend_limbs: np.ndarray, a: np.ndarray) -> np.ndarray:
    """M - a for a constant M as limbs [K, 1] and a uint64[K, n], M >= a."""
    out = np.broadcast_to(minuend_limbs, a.shape).copy()
    sub_limbs_masked(out, a, np.ones(a.shape[1:], dtype=bool))
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
