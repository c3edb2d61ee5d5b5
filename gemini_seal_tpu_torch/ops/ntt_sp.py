"""Kernel ``ntt_sp`` (K11): the cross-chunk stages of the coefficient-sharded
negacyclic NTT.

Port of the stage loops of gemini_seal_tpu/parallel/ntt_sp.py that pair
coefficients of two chunks (the chunk-local stages are K1's ``sub_row``
mode, ops/ntt.py):

- :func:`ntt_sp_exchange` (mode ``exchange``): one hypercube stage of
  ntt_forward_sharded (:106-119) or ntt_inverse_sharded (:185-208) on a
  rank's chunk and its partner's;
- :func:`ntt_sp_rows` (mode ``rows``): every cross stage of the four-step
  form (:259-272, :359-373) over the row axis of the transposed block
  [..., L, C, N / C^2].

On a CUDA tensor each launches csrc/ntt_sp.cu; on a CPU tensor each runs
its plain version, line for line after the JAX loop.
"""

from __future__ import annotations

import torch

from . import cuda, modops
from .backend import is_cuda
from .ntt import NTTTables

__all__ = ["exchange_params", "ntt_sp_exchange", "exchange_plain", "ntt_sp_rows",
           "rows_plain", "MAX_ROWS_CHUNKS"]

MAX_ROWS_CHUNKS = 8


def _log2(c: int) -> int:
    if c < 2 or c & (c - 1):
        raise ValueError(f"ntt_sp: {c} chunks is not a power of two >= 2")
    return c.bit_length() - 1


def exchange_params(n: int, chunks: int, stage: int, rank: int, inverse: bool):
    """(lower, twiddle index, last) of cross stage `stage` on rank `rank`:
    whether the rank keeps the butterfly's lower half, the stage's twiddle
    entry for its group (forward: root_powers[m + g]; inverse: the
    reordered inv_root_powers[ofs(stage) + g]), and whether this is the
    inverse's final stage (the n^-1 fold)."""
    log_n = n.bit_length() - 1
    log_c = _log2(chunks)
    chunk = n // chunks
    if not inverse:
        if not 0 <= stage < log_c:
            raise ValueError(f"forward cross stages are 0..{log_c - 1}, got {stage}")
        m = 1 << stage
        cd = chunks >> (stage + 1)
        g = rank >> (log_c - stage)
        return (rank & cd) == 0, m + g, False
    if not log_n - log_c <= stage < log_n:
        raise ValueError(f"inverse cross stages are {log_n - log_c}..{log_n - 1}, got {stage}")
    m = n >> (stage + 1)
    cd = (1 << stage) // chunk
    g = rank // (2 * cd)
    ofs = 1 + n - (n >> stage)
    return (rank & cd) == 0, ofs + g, m == 1


def exchange_plain(own, partner, tables: NTTTables, rank: int, chunks: int, stage: int,
                   inverse: bool, canonical: bool = False):
    """Plain version of :func:`ntt_sp_exchange` (ntt_sp.py:106-119, 185-208)."""
    lower, tw, last = exchange_params(tables.coeff_count, chunks, stage, rank, inverse)
    p = tables.modulus.reshape(-1, 1)
    two_p = p * 2
    x0, x1 = (own, partner) if lower else (partner, own)
    if not inverse:
        w = tables.root_powers[:, tw: tw + 1]
        ws = tables.scaled_root_powers[:, tw: tw + 1]
        x0 = torch.where(modops.uge(x0, two_p), x0 - two_p, x0)
        v = modops.mul_mod_shoup_lazy(x1, w, ws, p)
        return x0 + v if lower else x0 - v + two_p
    w = tables.inv_root_powers[:, tw: tw + 1]
    ws = tables.scaled_inv_root_powers[:, tw: tw + 1]
    t = x0 + x1
    t = torch.where(modops.uge(t, two_p), t - two_p, t)
    dd = x0 - x1 + two_p
    if last:
        inv_n = tables.inv_degree_modulo.reshape(-1, 1)
        inv_n_s = tables.scaled_inv_degree.reshape(-1, 1)
        t = modops.mul_mod_shoup_lazy(t, inv_n, inv_n_s, p)
    x = t if lower else modops.mul_mod_shoup_lazy(dd, w, ws, p)
    return modops.reduce_once(x, p) if last and canonical else x


def _consts(tables: NTTTables, inverse: bool):
    if inverse:
        w, ws = tables.inv_root_powers, tables.scaled_inv_root_powers
    else:
        w, ws = tables.root_powers, tables.scaled_root_powers
    consts = (w, ws, tables.modulus, tables.inv_degree_modulo, tables.scaled_inv_degree)
    for t in consts:
        cuda.check(t, "ntt_sp table")
    return consts


def ntt_sp_exchange(own, partner, tables: NTTTables, rank: int, chunks: int, stage: int,
                    inverse: bool, canonical: bool = False):
    """K11 mode ``exchange``: cross stage `stage` of the hypercube NTT on
    rank `rank` of `chunks`.

    own, partner: int64[..., L, N / chunks], the rank's chunk and that of
    its partner rank ^ (distance in chunks) (the ppermute's result).
    Returns the rank's chunk after the stage: forward lazy (the accumulating
    lane below 2p); inverse lazy, with n^-1 folded in on the last stage and,
    with ``canonical``, that stage's output reduced to [0, p)."""
    n = tables.coeff_count
    if own.shape != partner.shape or own.dim() < 2 or own.shape[-1] * chunks != n:
        raise ValueError(f"ntt_sp exchange: chunks {tuple(own.shape)} and "
                         f"{tuple(partner.shape)} of a ring of {n} over {chunks}")
    if not is_cuda(own, partner, tables.modulus):
        return exchange_plain(own, partner, tables, rank, chunks, stage, inverse, canonical)
    lower, tw, last = exchange_params(n, chunks, stage, rank, inverse)
    cuda.check(own, "ntt_sp own chunk")
    cuda.check(partner, "ntt_sp partner chunk")
    L = own.shape[-2]
    if tables.modulus.numel() != L:
        raise ValueError(f"ntt_sp: {tables.modulus.numel()} table rows for {L} limbs")
    consts = _consts(tables, inverse)
    out = torch.empty_like(own)
    if own.numel() == 0:
        return out
    cuda.call("ntt_sp", cuda.ptr(out), cuda.ptr(own), cuda.ptr(partner),
              own.numel() // own.shape[-1], L, tables.coeff_count_power, _log2(chunks), 0,
              int(inverse), int(lower), tw, int(last), int(canonical),
              *(cuda.ptr(t) for t in consts), mode="exchange")
    return out


def rows_plain(y, tables: NTTTables, chunks: int, inverse: bool, canonical: bool = False):
    """Plain version of :func:`ntt_sp_rows` (ntt_sp.py:259-272, 359-373)."""
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    log_c = _log2(chunks)
    shape = y.shape
    batch = shape[:-3]
    L, cc = shape[-3], shape[-1]
    p4 = tables.modulus.reshape(-1, 1, 1, 1)
    two_p4 = p4 * 2
    if not inverse:
        w_all, ws_all = tables.root_powers, tables.scaled_root_powers
        for s in range(log_c):
            m = 1 << s
            rows_h = chunks >> (s + 1)
            w = w_all[:, m: 2 * m].reshape(-1, m, 1, 1)
            ws = ws_all[:, m: 2 * m].reshape(-1, m, 1, 1)
            yr = y.reshape(batch + (L, m, 2, rows_h, cc))
            x0, x1 = yr[..., 0, :, :], yr[..., 1, :, :]
            x0 = torch.where(modops.uge(x0, two_p4), x0 - two_p4, x0)
            v = modops.mul_mod_shoup_lazy(x1, w, ws, p4)
            y = torch.stack([x0 + v, x0 - v + two_p4], dim=-3).reshape(shape)
        return y
    w_all, ws_all = tables.inv_root_powers, tables.scaled_inv_root_powers
    inv_n = tables.inv_degree_modulo.reshape(-1, 1, 1, 1)
    inv_n_s = tables.scaled_inv_degree.reshape(-1, 1, 1, 1)
    for s in range(log_n - log_c, log_n):
        m = n >> (s + 1)
        rows_h = chunks // (2 * m)
        ofs = 1 + n - (n >> s)
        w = w_all[:, ofs: ofs + m].reshape(-1, m, 1, 1)
        ws = ws_all[:, ofs: ofs + m].reshape(-1, m, 1, 1)
        yr = y.reshape(batch + (L, m, 2, rows_h, cc))
        x0, x1 = yr[..., 0, :, :], yr[..., 1, :, :]
        t = x0 + x1
        t = torch.where(modops.uge(t, two_p4), t - two_p4, t)
        dd = x0 - x1 + two_p4
        if m == 1:
            t = modops.mul_mod_shoup_lazy(t, inv_n, inv_n_s, p4)
        y1 = modops.mul_mod_shoup_lazy(dd, w, ws, p4)
        y = torch.stack([t, y1], dim=-3).reshape(shape)
    return modops.reduce_once(y, tables.modulus.reshape(-1, 1, 1)) if canonical else y


def ntt_sp_rows(y, tables: NTTTables, chunks: int, inverse: bool, canonical: bool = False):
    """K11 mode ``rows``: every cross stage of the four-step NTT on the
    transposed block y: int64[..., L, chunks, N / chunks^2] (row i holds
    rank i's piece of this rank's column block).

    Forward: stages 0 .. log2(chunks) - 1, lazy.  Inverse: the last
    log2(chunks) stages with n^-1 folded into the last; with ``canonical``
    the result is reduced to [0, p) (the JAX function's reduce_once after
    the transpose back: elementwise, so its place makes no difference)."""
    n = tables.coeff_count
    if y.dim() < 3 or y.shape[-2] != chunks or y.shape[-1] * chunks * chunks != n:
        raise ValueError(f"ntt_sp rows: expected [..., L, {chunks}, {n // max(chunks, 1) ** 2}],"
                         f" got {tuple(y.shape)}")
    if chunks > MAX_ROWS_CHUNKS:
        raise ValueError(f"ntt_sp rows: at most {MAX_ROWS_CHUNKS} chunks, got {chunks}")
    if not inverse and canonical:
        raise ValueError("ntt_sp rows: the forward cross stages are lazy")
    if not is_cuda(y, tables.modulus):
        return rows_plain(y, tables, chunks, inverse, canonical)
    cuda.check(y, "ntt_sp rows input")
    L = y.shape[-3]
    if tables.modulus.numel() != L:
        raise ValueError(f"ntt_sp: {tables.modulus.numel()} table rows for {L} limbs")
    consts = _consts(tables, inverse)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    cuda.call("ntt_sp", cuda.ptr(out), cuda.ptr(y), 0, y.numel() // (chunks * y.shape[-1]), L,
              tables.coeff_count_power, _log2(chunks), 1, int(inverse), 0, 0, 0,
              int(canonical), *(cuda.ptr(t) for t in consts), mode="rows")
    return out
