"""Coefficient-sharded (sequence-parallel) negacyclic NTT over a group.

Port of gemini_seal_tpu/parallel/ntt_sp.py.  The coefficient axis N is cut
into C = group.size contiguous chunks, chunk d on rank d, and the same
Harvey/Shoup lazy butterflies as ops.ntt run on them, bit for bit:

- hypercube form (:func:`ntt_forward_sharded`, :func:`ntt_inverse_sharded`):
  the forward's first log2(C) stages pair coefficients of two ranks; each
  is one ``ppermute`` with the rank at XOR distance and one K11
  ``exchange`` launch that keeps the rank's half of the butterfly (both
  partners compute the Shoup product rather than exchange twice); the
  remaining stages are chunk-local, one K1 ``sub_row`` launch.  The
  inverse mirrors it: local stages first, the cross stages last.
- four-step form (:func:`forward_4step_local`, :func:`inverse_4step_local`
  and the two ``_4step`` entry points): one ``all_to_all`` turns the
  chunks' column blocks into rows, every cross stage is one K11 ``rows``
  launch over them, and a second ``all_to_all`` turns them back: two
  transposes per transform instead of log2(C) exchanges.

Each function is the body of one rank: x is the rank's chunk [..., L, N/C]
and the output keeps that layout, equal chunk for chunk to
ops.ntt.ntt_forward / ntt_inverse of the whole array.  With C = 1 they are
the in-core transforms.
"""

from __future__ import annotations

from ..ops.ntt import (NTTTables, ntt_forward, ntt_forward_lazy, ntt_inverse,
                       ntt_inverse_lazy, ntt_sub_row)
from ..ops.ntt_sp import MAX_ROWS_CHUNKS, ntt_sp_exchange, ntt_sp_rows

__all__ = ["ntt_forward_sharded", "ntt_inverse_sharded", "ntt_forward_sharded_4step",
           "ntt_inverse_sharded_4step", "forward_4step_local", "inverse_4step_local",
           "check_hypercube", "check_4step"]


def _check_power(C: int):
    if C < 1 or C & (C - 1):
        raise ValueError("coeff axis size must be a power of two")


def check_hypercube(n: int, C: int):
    _check_power(C)
    if n % C or n // C < 2:
        raise ValueError("chunk too small for the mesh")


def check_4step(n: int, C: int):
    """The four-step form needs chunk >= C for the block transpose
    (ntt_sp.py:279-283), and the rows kernel holds at most 8 rows."""
    _check_power(C)
    if n % C or n // C < C:
        raise ValueError("need chunk >= C for the block transpose")
    if C > MAX_ROWS_CHUNKS:
        raise ValueError(f"the four-step form runs at most {MAX_ROWS_CHUNKS} ranks")


def _chunk(x, tables: NTTTables, C: int):
    if x.shape[-1] * C != tables.coeff_count:
        raise ValueError(f"expected a chunk of {tables.coeff_count // C} coefficients, "
                         f"got {tuple(x.shape)}")
    return x.contiguous()


def ntt_forward_sharded(x, tables: NTTTables, group):
    """Forward negacyclic NTT of this rank's chunk, hypercube schedule
    (ntt_sp.py:86-126); canonical output in [0, p).  log2(C) ppermutes."""
    C, d = group.size, group.rank
    check_hypercube(tables.coeff_count, C)
    x = _chunk(x, tables, C)
    if C == 1:
        return ntt_forward(x, tables)
    for s in range(C.bit_length() - 1):
        cd = C >> (s + 1)
        other = group.ppermute(x, [(i, i ^ cd) for i in range(C)])
        x = ntt_sp_exchange(x, other, tables, d, C, s, inverse=False)
    return ntt_sub_row(x, tables, d, C, inverse=False, canonical=True)


def ntt_inverse_sharded(x, tables: NTTTables, group):
    """Inverse negacyclic NTT of this rank's chunk, hypercube schedule
    (ntt_sp.py:129-213); canonical output in [0, p).  log2(C) ppermutes."""
    C, d = group.size, group.rank
    check_hypercube(tables.coeff_count, C)
    x = _chunk(x, tables, C)
    if C == 1:
        return ntt_inverse(x, tables)
    n, log_n = tables.coeff_count, tables.coeff_count_power
    chunk = n // C
    x = ntt_sub_row(x, tables, d, C, inverse=True)
    for s in range(log_n - (C.bit_length() - 1), log_n):
        cd = (1 << s) // chunk
        other = group.ppermute(x, [(i, i ^ cd) for i in range(C)])
        x = ntt_sp_exchange(x, other, tables, d, C, s, inverse=True, canonical=True)
    return x


def _blocks(x, C: int):
    """[..., L, chunk] -> [..., L, C, chunk / C], contiguous."""
    return x.reshape(x.shape[:-1] + (C, x.shape[-1] // C))


def forward_4step_local(xl, tables: NTTTables, group, lazy: bool = False):
    """The four-step forward body (ntt_sp.py:216-276): this rank's chunk
    [..., L, chunk] in, the same chunk of the transform out, lazy in
    [0, 4p) with ``lazy`` (ops.ntt.ntt_forward_lazy's contract), else
    canonical.  Two all_to_alls."""
    C, d = group.size, group.rank
    xl = _chunk(xl, tables, C)
    if C == 1:
        return ntt_forward_lazy(xl, tables) if lazy else ntt_forward(xl, tables)
    y = group.all_to_all(_blocks(xl, C), axis=-2)
    y = ntt_sp_rows(y, tables, C, inverse=False)
    x2 = group.all_to_all(y, axis=-2).reshape(xl.shape)
    return ntt_sub_row(x2, tables, d, C, inverse=False, canonical=not lazy)


def inverse_4step_local(xl, tables: NTTTables, group, lazy: bool = False):
    """The four-step inverse body (ntt_sp.py:304-377): input in [0, 2p);
    output lazy in [0, 2p) with ``lazy`` (ops.ntt.ntt_inverse_lazy's
    contract), else canonical.  Two all_to_alls."""
    C, d = group.size, group.rank
    xl = _chunk(xl, tables, C)
    if C == 1:
        return ntt_inverse_lazy(xl, tables) if lazy else ntt_inverse(xl, tables)
    x2 = ntt_sub_row(xl, tables, d, C, inverse=True)
    y = group.all_to_all(_blocks(x2, C), axis=-2)
    y = ntt_sp_rows(y, tables, C, inverse=True, canonical=not lazy)
    return group.all_to_all(y, axis=-2).reshape(xl.shape)


def ntt_forward_sharded_4step(x, tables: NTTTables, group):
    """Forward NTT of this rank's chunk, four-step schedule; canonical,
    equal to ntt_forward_sharded."""
    check_4step(tables.coeff_count, group.size)
    return forward_4step_local(x, tables, group)


def ntt_inverse_sharded_4step(x, tables: NTTTables, group):
    """Inverse NTT of this rank's chunk, four-step schedule; canonical,
    equal to ntt_inverse_sharded."""
    check_4step(tables.coeff_count, group.size)
    return inverse_4step_local(x, tables, group)
