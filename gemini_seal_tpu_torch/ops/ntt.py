"""Negacyclic NTT: host table precompute + transforms (kernel ``ntt``).

Port of gemini_seal_tpu/ops/ntt.py.  The table layout is bit-identical to
the reference's ``NTTTables`` (native/src/seal/util/ntt.cpp):

- ``root_powers``: powers of the minimal primitive 2N-th root psi in
  bit-scrambled order (ntt.cpp:101-111); entry m+i drives stage m.
- ``scaled_root_powers``: Shoup duals floor(w * 2^64 / p) (ntt.cpp:113-119).
- ``inv_root_powers``: psi^{-1} powers, *reordered for sequential access*
  (stage m = n/2 first), with n^{-1} merged into the last entry
  (ntt.cpp:85-98).
- ``reduce_precomp``: floor(2^64 / p) (ntt.h:176).

The transforms reproduce the JAX package's lazy dataflow bit for bit:
Shoup butterflies, forward output lazy in [0, 4p) with the accumulating
lane kept in [0, 2p) by a conditional subtract at every stage, inverse
output lazy in [0, 2p) with n^{-1} folded into the last stage.  On a CUDA
tensor they launch the hand-written kernel (csrc/ntt.cu), in its large-ring
mode above N=16384; on a CPU tensor they run the plain per-stage radix-2
version below.  :func:`ntt_sub_row` (the kernel's ``sub_row`` mode) runs
the chunk-local stages of the coefficient-sharded NTT
(parallel/ntt_sp.py) on one rank's chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import List, Sequence

import numpy as np
import torch

from ..modulus import Modulus
from ..utils import numth
from . import cuda, modops
from .backend import is_cuda, to_tensor

__all__ = ["NTTTables", "build_ntt_tables", "ntt_forward", "ntt_inverse",
           "ntt_forward_lazy", "ntt_inverse_lazy", "ntt_plain", "ntt_sub_row",
           "sub_row_plain", "MAX_KERNEL_N", "SHARED_N"]

U64 = 0xFFFFFFFFFFFFFFFF

# the kernel keeps a row of up to SHARED_N coefficients in one block's shared
# memory (227 KB on Hopper) and runs larger rings, up to SEAL's cap, in its
# large-ring mode (global-memory stages, then SHARED_N sub-rows)
SHARED_N = 16384
MAX_KERNEL_N = 65536


def _shoupify(x: int, p: int) -> int:
    """floor(x * 2^64 / p) (reference: ntt.cpp:18-24)."""
    return ((x << 64) // p) & U64


@dataclass
class NTTTables:
    """Per-modulus-set NTT tables, stacked over the limb axis.

    All arrays are uint64 with shape [L, N] (per-limb scalars are [L]),
    built on the host with exact integers.  :meth:`to` gives the device
    mirror: the same tables as contiguous int64 tensors on one device,
    which is what the transforms take.
    """

    coeff_count_power: int
    coeff_count: int
    moduli: List[int]
    roots: np.ndarray                 # [L] minimal primitive 2N-th roots
    root_powers: np.ndarray           # [L, N]
    scaled_root_powers: np.ndarray    # [L, N]
    inv_root_powers: np.ndarray       # [L, N] (reordered, n^-1 merged)
    scaled_inv_root_powers: np.ndarray
    inv_degree_modulo: np.ndarray     # [L]
    scaled_inv_degree: np.ndarray     # [L]
    reduce_precomp: np.ndarray        # [L] floor(2^64/p)
    modulus: np.ndarray               # [L]

    @property
    def n(self) -> int:
        return self.coeff_count

    def to(self, device) -> "NTTTables":
        """Mirror with every array field as an int64 tensor on `device`."""
        return replace(self, **{
            f.name: to_tensor(np.asarray(getattr(self, f.name)), device)
            for f in fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        })


def _powers_of_root_bit_scrambled(root: int, n: int, log_n: int, p: int) -> np.ndarray:
    """Powers of `root` laid out in bit-reversed order (ntt.cpp:101-111).

    destination[reverse_bits(i)] = root^i, built by the reference's chained
    walk: each step multiplies the previously-written value.
    """
    out = np.zeros(n, dtype=np.uint64)
    out[0] = 1
    prev = 1
    for i in range(1, n):
        idx = numth.reverse_bits(i, log_n)
        prev = (prev * root) % p
        out[idx] = prev
    return out


# Per-(n, modulus) single-row table cache: the modulus-switching chain reuses
# the same moduli at every level, so each prime's tables are built once.
_TABLE_CACHE: dict = {}


def _build_single(coeff_count_power: int, p: int):
    key = (coeff_count_power, p)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    n = 1 << coeff_count_power

    root = numth.try_minimal_primitive_root(2 * n, p)
    if root is None:
        raise ValueError(f"modulus {p:#x} does not support NTT of size {n}")
    inv_root = numth.try_invert_uint_mod(root, p)
    inv_n = numth.try_invert_uint_mod(n, p)
    if inv_root is None or inv_n is None:
        raise ValueError("invalid modulus")

    fwd = _powers_of_root_bit_scrambled(root, n, coeff_count_power, p)
    scaled_fwd = np.array([_shoupify(int(w), p) for w in fwd], dtype=np.uint64)

    inv = _powers_of_root_bit_scrambled(inv_root, n, coeff_count_power, p)
    # Reorder for sequential inverse access (ntt.cpp:85-95): walk stages
    # m = n/2 down to 1, emitting entries [m, 2m).
    reordered = np.zeros(n, dtype=np.uint64)
    pos = 1
    m = n >> 1
    while m > 0:
        reordered[pos : pos + m] = inv[m : 2 * m]
        pos += m
        m >>= 1
    # Merge n^{-1} into the last entry (ntt.cpp:96-98).
    reordered[n - 1] = (int(reordered[n - 1]) * inv_n) % p
    scaled_inv = np.array([_shoupify(int(w), p) for w in reordered], dtype=np.uint64)

    entry = (root, fwd, scaled_fwd, reordered, scaled_inv, inv_n,
             _shoupify(inv_n, p), _shoupify(1, p))
    _TABLE_CACHE[key] = entry
    return entry


def build_ntt_tables(coeff_count_power: int, moduli: Sequence) -> NTTTables:
    """Build NTT tables for each modulus, matching NTTTables::initialize
    (reference: ntt.cpp:37-99) bit-for-bit."""
    n = 1 << coeff_count_power
    mods = [m.value if isinstance(m, Modulus) else int(m) for m in moduli]
    L = len(mods)

    roots = np.zeros(L, dtype=np.uint64)
    root_powers = np.zeros((L, n), dtype=np.uint64)
    scaled_root_powers = np.zeros((L, n), dtype=np.uint64)
    inv_root_powers = np.zeros((L, n), dtype=np.uint64)
    scaled_inv_root_powers = np.zeros((L, n), dtype=np.uint64)
    inv_degree = np.zeros(L, dtype=np.uint64)
    scaled_inv_degree = np.zeros(L, dtype=np.uint64)
    reduce_precomp = np.zeros(L, dtype=np.uint64)

    for j, p in enumerate(mods):
        (root, fwd, scaled_fwd, inv_reord, scaled_inv, inv_n, inv_n_s, rdp) = (
            _build_single(coeff_count_power, p)
        )
        roots[j] = root
        root_powers[j] = fwd
        scaled_root_powers[j] = scaled_fwd
        inv_root_powers[j] = inv_reord
        scaled_inv_root_powers[j] = scaled_inv
        inv_degree[j] = inv_n
        scaled_inv_degree[j] = inv_n_s
        reduce_precomp[j] = rdp

    return NTTTables(
        coeff_count_power=coeff_count_power,
        coeff_count=n,
        moduli=mods,
        roots=roots,
        root_powers=root_powers,
        scaled_root_powers=scaled_root_powers,
        inv_root_powers=inv_root_powers,
        scaled_inv_root_powers=scaled_inv_root_powers,
        inv_degree_modulo=inv_degree,
        scaled_inv_degree=scaled_inv_degree,
        reduce_precomp=reduce_precomp,
        modulus=np.array(mods, dtype=np.uint64),
    )


def ntt_plain(x, tables: NTTTables, inverse: bool, canonical: bool):
    """Plain PyTorch version of the kernel: per-stage radix-2 butterflies,
    the JAX sequence exactly (ntt.py:241-403 with FUSE_STAGES = 1)."""
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    shape = x.shape
    lead = shape[:-1]
    p = tables.modulus.reshape(-1, 1, 1)
    two_p = p * 2
    if not inverse:
        w_all, ws_all = tables.root_powers, tables.scaled_root_powers
        for s in range(log_n):
            m = 1 << s
            h = n >> (s + 1)
            xr = x.reshape(lead + (m, 2, h))
            x0, x1 = xr[..., 0, :], xr[..., 1, :]
            w = w_all[:, m : 2 * m].reshape(-1, m, 1)
            ws = ws_all[:, m : 2 * m].reshape(-1, m, 1)
            x0 = torch.where(modops.uge(x0, two_p), x0 - two_p, x0)
            v = modops.mul_mod_shoup_lazy(x1, w, ws, p)
            x = torch.stack([x0 + v, x0 - v + two_p], dim=-2).reshape(shape)
        return modops.reduce_twice(x, p.reshape(-1, 1)) if canonical else x
    w_all, ws_all = tables.inv_root_powers, tables.scaled_inv_root_powers
    inv_n = tables.inv_degree_modulo.reshape(-1, 1, 1)
    inv_n_s = tables.scaled_inv_degree.reshape(-1, 1, 1)
    ofs = 1
    for s in range(log_n):
        m = n >> (s + 1)
        h = 1 << s
        xr = x.reshape(lead + (m, 2, h))
        x0, x1 = xr[..., 0, :], xr[..., 1, :]
        w = w_all[:, ofs : ofs + m].reshape(-1, m, 1)
        ws = ws_all[:, ofs : ofs + m].reshape(-1, m, 1)
        ofs += m
        tt = x0 + x1
        tt = torch.where(modops.uge(tt, two_p), tt - two_p, tt)
        d = x0 - x1 + two_p
        if s == log_n - 1:
            tt = modops.mul_mod_shoup_lazy(tt, inv_n, inv_n_s, p)
        x = torch.stack([tt, modops.mul_mod_shoup_lazy(d, w, ws, p)],
                        dim=-2).reshape(shape)
    return modops.reduce_once(x, p.reshape(-1, 1)) if canonical else x


def _transform(x, tables: NTTTables, inverse: bool, canonical: bool):
    if not is_cuda(x, tables.modulus):
        return ntt_plain(x, tables, inverse, canonical)
    cuda.check(x, "ntt input")
    n, log_n = tables.coeff_count, tables.coeff_count_power
    if x.dim() < 2 or x.shape[-1] != n:
        raise ValueError(f"ntt: expected [..., L, {n}], got {tuple(x.shape)}")
    L = x.shape[-2]
    if tables.modulus.numel() != L:
        raise ValueError(f"ntt: {tables.modulus.numel()} table rows for {L} limbs")
    if n > MAX_KERNEL_N or n < 2:
        raise ValueError(f"ntt kernel: N={n} is outside [2, {MAX_KERNEL_N}]")
    if inverse:
        w, ws = tables.inv_root_powers, tables.scaled_inv_root_powers
    else:
        w, ws = tables.root_powers, tables.scaled_root_powers
    consts = (w, ws, tables.modulus, tables.inv_degree_modulo, tables.scaled_inv_degree)
    for t in consts:
        cuda.check(t, "ntt table")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    large = n > SHARED_N
    # the large-ring forward stages write scratch that its sub-row launch reads
    tmp = torch.empty_like(x) if large and not inverse else None
    cuda.call("ntt", cuda.ptr(out), cuda.ptr(x), cuda.ptr(tmp), x.numel() // n, L, log_n,
              log_n, 0, *(cuda.ptr(t) for t in consts), int(inverse), int(canonical),
              mode="large_ring" if large else None)
    return out


def ntt_forward_lazy(x, tables: NTTTables):
    """Forward negacyclic NTT over the last axis; output lazy in [0, 4p).

    x: int64[..., L, N]; tables: the device mirror (NTTTables.to) on x's
    device.  Mirrors ntt_negacyclic_harvey_lazy (reference: ntt.cpp:292-342).
    """
    return _transform(x, tables, inverse=False, canonical=False)


def ntt_forward(x, tables: NTTTables):
    """Forward NTT with canonical output in [0, p)."""
    return _transform(x, tables, inverse=False, canonical=True)


def ntt_inverse_lazy(x, tables: NTTTables):
    """Inverse negacyclic NTT over the last axis; input and output lazy in
    [0, 2p).  Mirrors inverse_ntt_negacyclic_harvey_lazy (ntt.cpp:345-404)
    including the reordered twiddle walk and the n^{-1} fold."""
    return _transform(x, tables, inverse=True, canonical=False)


def ntt_inverse(x, tables: NTTTables):
    """Inverse NTT with canonical output in [0, p)."""
    return _transform(x, tables, inverse=True, canonical=True)


# --------------------------------------------------------------------------
# mode sub_row: the chunk-local stages of the coefficient-sharded NTT
# --------------------------------------------------------------------------

def _sub_row_check(x, tables: NTTTables, rank: int, chunks: int):
    n = tables.coeff_count
    if chunks < 2 or chunks & (chunks - 1) or n % chunks or n // chunks < 2:
        raise ValueError(f"ntt sub_row: {chunks} chunks of a ring of {n}")
    if not 0 <= rank < chunks:
        raise ValueError(f"ntt sub_row: chunk {rank} of {chunks}")
    if x.dim() < 2 or x.shape[-1] != n // chunks:
        raise ValueError(f"ntt sub_row: expected [..., L, {n // chunks}], got {tuple(x.shape)}")


def sub_row_plain(x, tables: NTTTables, rank: int, chunks: int, inverse: bool,
                  canonical: bool):
    """Plain version of :func:`ntt_sub_row`: the JAX loops
    (parallel/ntt_sp.py:56-83, :160-182) on chunk `rank` of `chunks`."""
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    log_c = chunks.bit_length() - 1
    shape = x.shape
    lead = shape[:-1]
    p = tables.modulus.reshape(-1, 1, 1)
    two_p = p * 2
    d = rank
    if not inverse:
        w_all, ws_all = tables.root_powers, tables.scaled_root_powers
        for s in range(log_c, log_n):
            m = 1 << s
            h = n >> (s + 1)
            lg = max(m // chunks, 1)
            w = w_all[:, m + d * lg: m + (d + 1) * lg].reshape(-1, lg, 1)
            ws = ws_all[:, m + d * lg: m + (d + 1) * lg].reshape(-1, lg, 1)
            xr = x.reshape(lead + (lg, 2, h))
            x0, x1 = xr[..., 0, :], xr[..., 1, :]
            x0 = torch.where(modops.uge(x0, two_p), x0 - two_p, x0)
            v = modops.mul_mod_shoup_lazy(x1, w, ws, p)
            x = torch.stack([x0 + v, x0 - v + two_p], dim=-2).reshape(shape)
        return modops.reduce_twice(x, p.reshape(-1, 1)) if canonical else x
    if canonical:
        raise ValueError("ntt sub_row: the inverse chunk stages are lazy")
    w_all, ws_all = tables.inv_root_powers, tables.scaled_inv_root_powers
    ofs = 1
    for s in range(log_n - log_c):
        m = n >> (s + 1)
        h = 1 << s
        lg = m // chunks
        w = w_all[:, ofs + d * lg: ofs + (d + 1) * lg].reshape(-1, lg, 1)
        ws = ws_all[:, ofs + d * lg: ofs + (d + 1) * lg].reshape(-1, lg, 1)
        ofs += m
        xr = x.reshape(lead + (lg, 2, h))
        x0, x1 = xr[..., 0, :], xr[..., 1, :]
        tt = x0 + x1
        tt = torch.where(modops.uge(tt, two_p), tt - two_p, tt)
        dd = x0 - x1 + two_p
        x = torch.stack([tt, modops.mul_mod_shoup_lazy(dd, w, ws, p)], dim=-2).reshape(shape)
    return x


def ntt_sub_row(x, tables: NTTTables, rank: int, chunks: int, inverse: bool,
                canonical: bool = False):
    """K1 mode ``sub_row``: the stages of the negacyclic NTT that stay inside
    chunk `rank` of `chunks` contiguous chunks of the ring, on x:
    int64[..., L, N / chunks], that rank's coefficients.

    Forward: the last log2(N / chunks) stages (after the cross-chunk stages),
    output lazy in [0, 4p) or, with ``canonical``, reduced to [0, p).
    Inverse: the first log2(N / chunks) stages (before the cross-chunk
    stages), lazy, with no n^-1 fold.  Every value is the JAX loop's
    (parallel/ntt_sp.py:56-83, :160-182)."""
    _sub_row_check(x, tables, rank, chunks)
    if not is_cuda(x, tables.modulus):
        return sub_row_plain(x, tables, rank, chunks, inverse, canonical)
    if inverse and canonical:
        raise ValueError("ntt sub_row: the inverse chunk stages are lazy")
    cuda.check(x, "ntt sub_row input")
    n, log_n = tables.coeff_count, tables.coeff_count_power
    chunk = n // chunks
    L = x.shape[-2]
    if tables.modulus.numel() != L:
        raise ValueError(f"ntt: {tables.modulus.numel()} table rows for {L} limbs")
    if n > MAX_KERNEL_N:
        raise ValueError(f"ntt kernel: N={n} is above {MAX_KERNEL_N}")
    if inverse:
        w, ws = tables.inv_root_powers, tables.scaled_inv_root_powers
    else:
        w, ws = tables.root_powers, tables.scaled_root_powers
    consts = (w, ws, tables.modulus, tables.inv_degree_modulo, tables.scaled_inv_degree)
    for t in consts:
        cuda.check(t, "ntt table")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tmp = torch.empty_like(x) if chunk > SHARED_N and not inverse else None
    cuda.call("ntt", cuda.ptr(out), cuda.ptr(x), cuda.ptr(tmp), x.numel() // chunk, L, log_n,
              chunk.bit_length() - 1, rank, *(cuda.ptr(t) for t in consts), int(inverse),
              int(canonical), mode="sub_row")
    return out
