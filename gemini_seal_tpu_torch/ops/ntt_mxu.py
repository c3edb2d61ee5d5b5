"""Four-step negacyclic NTT as int8 digit-pair matmuls (kernel ``ntt_mxu``).

Port of gemini_seal_tpu/ops/ntt_mxu.py, the transform that the JAX package
built for the TPU's matrix unit and measured at 0.21-0.44x its radix-2 NTT
on a v5e (PERF.md's TPU table).  N = N1 * N2; the forward transform is a
size-N1 negacyclic column pass (pass "A": the data's outer axis is
contracted), one Shoup twist, and a size-N2 cyclic row pass with
bit-reversed output (pass "B": the inner axis is contracted); the inverse
runs the row pass, the untwist and the column pass (N^-1 folded into its
matrix).  Each pass splits the matrix entries and the data into balanced
base-256 digits (int8), sums the DW x DX digit-pair products by total shift
s = d + e in int32, and recombines the S = DW + DX - 1 planes as an exact
128-bit ladder plus one Barrett reduction.  Outputs are canonical and equal
to the radix-2 transform's bit for bit.

What each part replaces (gemini_seal_tpu/ops/ntt_mxu.py):

- :class:`MxuNttTables`, :func:`build_mxu_ntt_tables` and their helpers:
  :62-272 (the same arrays byte for byte, the same ``ValueError`` for
  moduli too large for the 128-bit recombine), held as tensors on the
  caller's device: the digit planes int8, the u64 arrays as int64 bit
  patterns (:mod:`.backend`);
- :func:`_balanced_digits_dev`: :275-286;
- :func:`_digit_matmul`: :289-318;
- :func:`_combine_planes`: :321-359;
- :func:`mxu_pass` (kernel ``ntt_mxu``, csrc/ntt_mxu.cu): :362-367
  ``_pass``, plus the twist of :380 / :399 (``mul_mod_shoup``,
  ops/modops.py:184-190) as the epilogue of each direction's first pass;
  the kernel sums each limb's own digit pairs only (``limb_ndig_w``,
  ``limb_ndig_x``: the pairs left out multiply zeros) and folds the planes
  five at a time into a residue by Shoup products (``fold_constants``) in
  place of the 128-bit ladder's one Barrett reduction: the same canonical
  value (:func:`mxu_pass_plain_limbs` is its sum in plain PyTorch);
- :func:`ntt_forward_mxu`, :func:`ntt_inverse_mxu`: :370-404, two launches
  each.

On a CPU tensor :func:`mxu_pass` runs its plain version, the JAX arithmetic
step by step; on a CUDA tensor it launches the kernel, whose digit-pair
products run on the int8 tensor cores (wgmma).  Its floor on an H100
(700 W) is the tensor cores' 989.5e12 int8 MACs/s: dw_l x dx_l digit pairs
x N1 x N1 x N2 (pass A) or N1 x N2 x N2 (pass B) MACs a poly-limb row,
0.13 ms a pass at N=16384 on 1,536 rows (primes of 50, 40 x 4 and 50 bits,
batch 128 x 2: 40.3 pairs a limb on average; 0.16 ms at the tables' 49),
beside 0.12 ms for its bytes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..modulus import Modulus
from ..utils import numth
from . import cuda, modops
from .backend import is_cuda, resolve_device, to_tensor

__all__ = ["MxuNttTables", "build_mxu_ntt_tables", "ntt_forward_mxu", "ntt_inverse_mxu",
           "mxu_pass", "mxu_pass_plain", "mxu_pass_plain_limbs", "limb_counts",
           "ntt_mxu_geometry", "ntt_mxu_layout", "GEOM_FIELDS", "fold_constants", "MXU_MAX_L"]

U64 = 0xFFFFFFFFFFFFFFFF
DIGIT_BITS = 8
BASE = 1 << DIGIT_BITS
# the carry-free lane offset 0x80..80 of the data split, as an int64 bit pattern
_LANE_OFFSET = int("80" * 8, 16) - (1 << 64)
# what the kernel takes: at most 7 weight and 8 data digits (15 planes,
# three groups of five) and 64 limbs a launch (the counts go by value,
# csrc/ntt_mxu.cu MAX_L)
KERNEL_DW_MAX, KERNEL_DX_MAX = 7, 8
MXU_MAX_L = 64
# the four digit-plane tables of MxuNttTables
_TABLES = ("fwd_col", "fwd_row", "inv_col", "inv_row")


def _shoupify(x: int, p: int) -> int:
    return ((x << 64) // p) & U64


def _offset_const(ndig: int) -> int:
    """sum_{i<ndig} 128 * 256^i: the balanced-digit lane offset."""
    return 128 * ((BASE ** ndig - 1) // (BASE - 1))


def _balanced_digits_host(mat_obj, ndig: int) -> np.ndarray:
    """Python-int matrix (object array) -> [ndig, ...] int8 balanced
    base-256 digits with sum_d digits[d] * 256^d == entry exactly."""
    out = np.zeros((ndig,) + mat_obj.shape, dtype=np.int8)
    flat = [int(v) for v in mat_obj.ravel()]
    for d in range(ndig):
        row = []
        nxt = []
        for v in flat:
            r = v % BASE
            if r >= BASE // 2:
                r -= BASE
            row.append(r)
            nxt.append((v - r) // BASE)
        out[d] = np.array(row, dtype=np.int8).reshape(mat_obj.shape)
        flat = nxt
    if any(v != 0 for v in flat):
        raise ValueError("matrix entries do not fit in the digit budget")
    return out


def _digits_for_balanced(vmax: int) -> int:
    """Smallest d with balanced base-256 digits covering [0, vmax]."""
    d = 1
    while _offset_const(d) < vmax:
        d += 1
    return d


def _digits_for_data(vmax: int) -> int:
    """Smallest d such that the +offset lane trick is carry-free:
    vmax + offset(d) < 256^d."""
    d = 1
    while vmax + _offset_const(d) >= BASE ** d:
        d += 1
    return d


def _split_n(n: int) -> tuple:
    """N = N1 * N2 with the column (first-pass) contraction at 128 when
    possible."""
    log_n = n.bit_length() - 1
    l1 = min(7, max(1, log_n - 1))
    l2 = log_n - l1
    return 1 << l1, 1 << l2


@dataclass
class MxuNttTables:
    """Per-modulus-set four-step tables, stacked over the limb axis L, as
    tensors on one device (the JAX dataclass's fields and values)."""

    n: int
    n1: int
    n2: int
    moduli: List[int]
    ndig_w: int                  # matrix digit count (balanced)
    ndig_x: int                  # data digit count (balanced, offset trick)
    fwd_col: torch.Tensor        # int8 [L, DW, N1, N1] (out j1 <- contraction k1)
    fwd_row: torch.Tensor        # int8 [L, DW, N2, N2] (out j2 <- contraction k2)
    fwd_twist: torch.Tensor      # u64 [L, N1, N2]
    fwd_twist_shoup: torch.Tensor
    inv_col: torch.Tensor        # int8 [L, DW, N1, N1] (N^-1 folded; out k1 <- j1)
    inv_row: torch.Tensor        # int8 [L, DW, N2, N2] (out k2 <- j2)
    inv_twist: torch.Tensor      # u64 [L, N1, N2]
    inv_twist_shoup: torch.Tensor
    modulus: torch.Tensor        # u64 [L]
    ratio0: torch.Tensor         # u64 [L] Barrett lo word of floor(2^128/p)
    ratio1: torch.Tensor         # u64 [L] Barrett hi word
    neg_offset: torch.Tensor     # u64 [L, 2] (lo, hi) multiple-of-p ladder offset
    # beyond the JAX fields: each limb's own digit counts, over which the
    # kernel sums (the pairs above them multiply zeros).  limb_ndig_w[name][l]
    # is 1 + the highest plane of table `name`'s limb l that holds a nonzero
    # byte; limb_ndig_x[l] is _digits_for_data(2 p_l - 1), above which every
    # digit of an x in [0, 2 p_l) is 0.
    limb_ndig_w: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    limb_ndig_x: Tuple[int, ...] = ()


def _planes_used(dig: np.ndarray) -> Tuple[int, ...]:
    """1 + the highest digit plane of each limb of an int8 [L, DW, K, K]
    table that holds a nonzero byte (at least 1)."""
    nz = dig.reshape(dig.shape[0], dig.shape[1], -1).any(axis=2)
    return tuple(1 + max([d for d in range(dig.shape[1]) if row[d]] or [0]) for row in nz)


def build_mxu_ntt_tables(coeff_count_power: int, moduli: Sequence,
                         device=None) -> MxuNttTables:
    """The JAX build_mxu_ntt_tables (ntt_mxu.py:131-272) with the port's
    number theory, its arrays as tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    n = 1 << coeff_count_power
    n1, n2 = _split_n(n)
    log_n1 = n1.bit_length() - 1
    log_n2 = n2.bit_length() - 1
    mods = [m.value if isinstance(m, Modulus) else int(m) for m in moduli]
    L = len(mods)
    pmax = max(mods)
    # data may be lazy in [0, 2p)
    ndig_w = _digits_for_balanced(pmax - 1)
    ndig_x = _digits_for_data(2 * pmax - 1)

    # Exact worst-case headroom check for the 128-bit recombine ladder:
    # |R_s| <= npairs(s) * K * 128 * 128 summed with shifts, plus the
    # positive offset, must stay below 2^128.
    s_planes = ndig_w + ndig_x - 1
    kmax = max(n1, n2)
    mag_bound = 0
    for s in range(s_planes):
        npairs = min(ndig_w, s + 1) - max(0, s - ndig_x + 1)
        mag_bound += (npairs * kmax * 128 * 128) << (DIGIT_BITS * s)
    off_target = 2 * mag_bound  # offset >= |negative sum|; total < offset+mag
    if (off_target + mag_bound) >> 128:
        raise ValueError(
            "moduli too large for the 128-bit MXU digit recombine "
            f"(need < ~2^55 at N={n}); use ops/ntt.py instead"
        )

    fwd_col = np.zeros((L, ndig_w, n1, n1), dtype=np.int8)
    fwd_row = np.zeros((L, ndig_w, n2, n2), dtype=np.int8)
    inv_col = np.zeros((L, ndig_w, n1, n1), dtype=np.int8)
    inv_row = np.zeros((L, ndig_w, n2, n2), dtype=np.int8)
    fwd_twist = np.zeros((L, n1, n2), dtype=np.uint64)
    fwd_twist_s = np.zeros((L, n1, n2), dtype=np.uint64)
    inv_twist = np.zeros((L, n1, n2), dtype=np.uint64)
    inv_twist_s = np.zeros((L, n1, n2), dtype=np.uint64)
    neg_off = np.zeros((L, 2), dtype=np.uint64)
    ratio0 = np.zeros(L, dtype=np.uint64)
    ratio1 = np.zeros(L, dtype=np.uint64)

    def powers(base, count):
        out, cur = [], 1
        for _ in range(count):
            out.append(cur)
            cur = (cur * base) % p
        return out

    for li, p in enumerate(mods):
        psi = numth.try_minimal_primitive_root(2 * n, p)
        if psi is None:
            raise ValueError(f"modulus {p:#x} does not support NTT of size {n}")
        psi_inv = numth.try_invert_uint_mod(psi, p)
        n_inv = numth.try_invert_uint_mod(n, p)
        e1 = [2 * numth.reverse_bits(j1, log_n1) + 1 for j1 in range(n1)]

        # column pass: A[j1, k1] = psi1^{e1(j1) * k1}, psi1 = psi^{N2}
        psi1 = pow(psi, n2, p)
        a = np.array([powers(pow(psi1, e1[j1], p), n1) for j1 in range(n1)], dtype=object)
        fwd_col[li] = _balanced_digits_host(a, ndig_w)

        # row pass: B[j2, k2] = w2^{br2(j2) * k2}, w2 = psi^{2*N1}
        w2 = pow(psi, 2 * n1, p)
        b = np.array([powers(pow(w2, numth.reverse_bits(j2, log_n2), p), n2)
                      for j2 in range(n2)], dtype=object)
        fwd_row[li] = _balanced_digits_host(b, ndig_w)

        # twist[j1, k2] = psi^{e1(j1) * k2}
        tw = np.array([powers(pow(psi, e1[j1], p), n2) for j1 in range(n1)], dtype=object)
        fwd_twist[li] = tw.astype(np.uint64)
        fwd_twist_s[li] = np.array(
            [_shoupify(int(v), p) for v in tw.ravel()], dtype=np.uint64
        ).reshape(n1, n2)

        # ---- inverse ----
        # row pass first: V[j1,k2] = sum_j2 U[j1,j2] * w2^{-br2(j2)*k2}
        w2i = numth.try_invert_uint_mod(w2, p)
        bi = np.zeros((n2, n2), dtype=object)
        for k2 in range(n2):
            for j2 in range(n2):
                bi[k2, j2] = pow(w2i, numth.reverse_bits(j2, log_n2) * k2, p)
        inv_row[li] = _balanced_digits_host(bi, ndig_w)

        # untwist[j1, k2] = psi^{-e1(j1) * k2}
        twi = np.array([powers(pow(psi_inv, e1[j1], p), n2) for j1 in range(n1)],
                       dtype=object)
        inv_twist[li] = twi.astype(np.uint64)
        inv_twist_s[li] = np.array(
            [_shoupify(int(v), p) for v in twi.ravel()], dtype=np.uint64
        ).reshape(n1, n2)

        # column pass: x[k1,k2] = sum_j1 Ai[k1,j1] * W[j1,k2],
        # Ai[k1,j1] = psi1^{-e1(j1)*k1} * N^{-1}
        psi1_inv = numth.try_invert_uint_mod(psi1, p)
        ai = np.zeros((n1, n1), dtype=object)
        for k1 in range(n1):
            for j1 in range(n1):
                ai[k1, j1] = (pow(psi1_inv, (e1[j1] * k1) % (2 * n1), p) * n_inv) % p
        inv_col[li] = _balanced_digits_host(ai, ndig_w)

        # ladder offset: smallest multiple of p >= off_target
        off = ((off_target + p - 1) // p) * p
        neg_off[li, 0] = off & U64
        neg_off[li, 1] = (off >> 64) & U64
        quot = (1 << 128) // p
        ratio0[li] = quot & U64
        ratio1[li] = (quot >> 64) & U64

    def i8(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    limb_w = {name: _planes_used(arr) for name, arr in
              zip(_TABLES, (fwd_col, fwd_row, inv_col, inv_row))}
    return MxuNttTables(
        n=n, n1=n1, n2=n2, moduli=mods, ndig_w=ndig_w, ndig_x=ndig_x,
        fwd_col=i8(fwd_col), fwd_row=i8(fwd_row),
        fwd_twist=to_tensor(fwd_twist, dev), fwd_twist_shoup=to_tensor(fwd_twist_s, dev),
        inv_col=i8(inv_col), inv_row=i8(inv_row),
        inv_twist=to_tensor(inv_twist, dev), inv_twist_shoup=to_tensor(inv_twist_s, dev),
        modulus=to_tensor(np.array(mods, dtype=np.uint64), dev),
        ratio0=to_tensor(ratio0, dev), ratio1=to_tensor(ratio1, dev),
        neg_offset=to_tensor(neg_off, dev),
        limb_ndig_w=limb_w, limb_ndig_x=tuple(_digits_for_data(2 * p - 1) for p in mods),
    )


def _balanced_digits_dev(x, ndig: int):
    """u64 data (int64 bit patterns) -> int8 [ndig, ...] balanced base-256
    digits.

    Carry-free trick: lanes of (x + 0x80..80) minus 128 are the balanced
    digits of x, provided x + offset(ndig) < 256^ndig (the table builder's
    digit count).  An arithmetic shift then the 0xFF mask reads a lane of
    the int64 bit pattern exactly."""
    xs = x + _LANE_OFFSET
    return torch.stack([(((xs >> (8 * d)) & 0xFF) - 128).to(torch.int8)
                        for d in range(ndig)], dim=0)


def _digit_matmul(x_dig, w_dig, contract_x: str):
    """Digit-pair matmuls regrouped by total shift s = d + e.

    x_dig: int8 [DX, ..., L, A, B]; w_dig: int8 [L, DW, O, K].
    contract_x 'A' contracts the data's axis A against K (out
    [..., L, O, B]), 'B' its axis B (out [..., L, A, O]).  Returns the S
    int64 planes.  The products run as float64 matmuls (the card has no
    int64 matmul) and are cast back: every product sum is at most
    K * 2^14 <= 2^23 in magnitude, far below 2^53, so each is exact, and so
    is the int64 sum of a shift's pairs (the JAX int32 planes, widened)."""
    dx = x_dig.shape[0]
    dw = w_dig.shape[1]
    wf = w_dig.to(torch.float64)
    xf = x_dig.to(torch.float64)
    sub = "lok,...lkb->...lob" if contract_x == "A" else "lok,...lak->...lao"
    planes = []
    for s in range(dx + dw - 1):
        acc = None
        for d in range(max(0, s - dx + 1), min(dw, s + 1)):
            t = torch.einsum(sub, wf[:, d], xf[s - d]).to(torch.int64)
            acc = t if acc is None else acc + t
        planes.append(acc)
    return planes


def _combine_planes(planes, tables: MxuNttTables):
    """[S] planes -> u64 in [0, p): offset + sum_s plane_s * 2^{8 s} as an
    exact 128-bit (hi, lo) pair (the offset a multiple of p above any
    negative partial), then one Barrett reduction; the JAX step sequence."""
    shape = planes[0].shape
    p = tables.modulus.reshape(-1, 1, 1)
    r0 = tables.ratio0.reshape(-1, 1, 1)
    r1 = tables.ratio1.reshape(-1, 1, 1)
    lo = tables.neg_offset[:, 0].reshape(-1, 1, 1).expand(shape)
    hi = tables.neg_offset[:, 1].reshape(-1, 1, 1).expand(shape)
    for s, v64 in enumerate(planes):
        neg = v64 < 0
        mag = torch.where(neg, -v64, v64)
        shift = DIGIT_BITS * s
        if shift == 0:
            m_lo, m_hi = mag, torch.zeros_like(mag)
        elif shift < 64:
            m_lo = mag << shift
            m_hi = modops.shr(mag, 64 - shift)
        else:
            # |plane| < 2^31 and shift - 64 stays below 64 by the builder's
            # headroom check
            m_lo = torch.zeros_like(mag)
            m_hi = mag << (shift - 64)
        add_lo = lo + m_lo
        add_hi = hi + m_hi + modops.ult(add_lo, lo).long()
        sub_lo = lo - m_lo
        sub_hi = hi - m_hi - modops.ult(lo, m_lo).long()
        lo = torch.where(neg, sub_lo, add_lo)
        hi = torch.where(neg, sub_hi, add_hi)
    return modops.barrett_reduce_128(hi, lo, p, r0, r1)


def mxu_pass_plain(x, w_dig, tables: MxuNttTables, contract_x: str, twist=None):
    """Plain version of :func:`mxu_pass`: digit split, digit-pair matmuls,
    recombine, and the canonical Shoup twist when ``twist`` is given;
    contiguous, as the kernel writes it."""
    x_dig = _balanced_digits_dev(x, tables.ndig_x)
    out = _combine_planes(_digit_matmul(x_dig, w_dig, contract_x), tables)
    if twist is not None:
        out = modops.mul_mod_shoup(out, twist[0], twist[1], tables.modulus.reshape(-1, 1, 1))
    return out.contiguous()


def limb_counts(w_dig, tables: MxuNttTables) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Each limb's (weight, data) digit counts for a pass with the digit
    planes ``w_dig``: the tables' own counts for one of their four tables,
    the tables' largest counts for any other tensor (which skips nothing)."""
    for name in _TABLES:
        if getattr(tables, name) is w_dig and name in tables.limb_ndig_w:
            return tables.limb_ndig_w[name], tables.limb_ndig_x
    L = len(tables.moduli)
    return (tables.ndig_w,) * L, (tables.ndig_x,) * L


def mxu_pass_plain_limbs(x, w_dig, tables: MxuNttTables, contract_x: str, twist=None,
                         counts=None):
    """The kernel's sum in plain PyTorch: :func:`mxu_pass_plain` with each
    limb's planes summed over its own digit pairs only (``counts``, else
    :func:`limb_counts`), then the same offset, ladder and Barrett
    reduction.  Equal bit for bit to :func:`mxu_pass_plain`: the pairs left
    out multiply zeros."""
    dws, dxs = counts if counts is not None else limb_counts(w_dig, tables)
    s_max = tables.ndig_w + tables.ndig_x - 1
    per_limb = []
    for li in range(len(tables.moduli)):
        x_dig = _balanced_digits_dev(x[..., li:li + 1, :, :], dxs[li])
        pl = _digit_matmul(x_dig, w_dig[li:li + 1, :dws[li]], contract_x)
        per_limb.append(pl + [torch.zeros_like(pl[0])] * (s_max - len(pl)))
    planes = [torch.cat([pl[s] for pl in per_limb], dim=-3) for s in range(s_max)]
    out = _combine_planes(planes, tables)
    if twist is not None:
        out = modops.mul_mod_shoup(out, twist[0], twist[1], tables.modulus.reshape(-1, 1, 1))
    return out.contiguous()


# the int64 launch description that csrc/ntt_mxu.cu takes from the host, in
# its order (gst_ntt_mxu checks each against its instantiations)
GEOM_FIELDS = ("nt", "mt", "log_mblocks", "log_ntiles", "stages", "plane_bytes", "stage_bytes",
               "box_bytes", "raw_half", "boxes", "w_off", "st_off", "raw_off", "smem", "grid_x")
_SMEM_LIMIT = 232448   # the card's shared memory a CTA (227 KB)


def ntt_mxu_layout(nt: int, K: int, n: int, R: int, L: int, dwt: int, dxt: int, mode: int,
                   sms: int) -> dict:
    """The launch of a pass at ``nt`` data columns a stage: W's 64-row tiles a
    CTA (mt) and 128-row blocks a limb (2^log_mblocks, grid y = L <<
    log_mblocks), a row's nt-column data tiles (2^log_ntiles), the items
    (data tiles) of a limb, the persistent grid's x (one CTA an SM), and
    the shared-memory layout: mbarriers and constants (256 bytes), W's
    digit planes where they stay resident (K <= 128), as many stages as fit
    (at most 8), the two raw halves of TMA boxes 1024-byte aligned."""
    res = K <= 128
    Kp = max(32, K)
    kst = Kp // 32
    mt = (2 if K > 64 else 1) if res else 2
    log_mblocks = 0 if res else (K // 128).bit_length() - 1
    log_ntiles = (n // nt).bit_length() - 1 if n > nt else 0
    items = (R // L) << log_ntiles
    plane = nt * Kp
    stage = dxt * plane
    boxes = nt // 16 if mode == 0 else Kp // 16
    box = (Kp // 2 if mode == 0 else nt // 2) * 16 * 8
    half = boxes * box
    w_off = 256
    st_off = (w_off + (dwt * kst * mt * 2048 if res else 0) + 127) & ~127
    stages = min(8, (_SMEM_LIMIT - st_off - 2 * half - 1024) // stage)
    raw_off = st_off + stages * stage
    ys = L << log_mblocks
    return {"nt": nt, "resident": res, "Kp": Kp, "mt": mt, "log_mblocks": log_mblocks,
            "log_ntiles": log_ntiles, "items": items, "grid_x": max(1, min(items, sms // ys)),
            "grid_y": ys, "plane_bytes": plane, "stage_bytes": stage, "boxes": boxes,
            "box_bytes": box, "raw_half": half, "w_off": w_off, "st_off": st_off,
            "stages": stages, "raw_off": raw_off, "smem": raw_off + 2 * half + 1024}


def ntt_mxu_geometry(K: int, n: int, R: int, L: int, dwt: int, dxt: int, mode: int,
                     sms: int = 132) -> dict:
    """The launch of kernel ntt_mxu for a pass that contracts K over n
    columns on R rows of L limbs: 32 data columns a stage with W's digit
    planes resident in shared memory up to K = 128, else 16 with W's
    fragments from device memory (:func:`ntt_mxu_layout`; 16 columns with W
    resident measured slower, port_tools/ntt_mxu_variants.py).  sms: the
    card's SMs."""
    return ntt_mxu_layout(32 if K <= 128 else 16, K, n, R, L, dwt, dxt, mode, sms)


@functools.lru_cache(maxsize=None)
def _host_geometry(K, n, R, L, dwt, dxt, mode, sms) -> np.ndarray:
    g = ntt_mxu_geometry(K, n, R, L, dwt, dxt, mode, sms)
    return np.array([g[f] for f in GEOM_FIELDS], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the kernel sums five planes (40 bits of shift) into an int64 partial
# before it folds them into a limb's running residue, three groups for the
# at most 15 planes
FOLD_PLANES = 5
FOLD_GROUPS = 3
# |partial| < 7 * 512 * 2^14 * 2^32 * (1 + 2^-8 + ...) < 2^58
FOLD_BOUND = 1 << 58


def fold_constants(moduli) -> np.ndarray:
    """The by-value constants of the kernel's fold, u64 [5L]: each limb's
    bias (the least multiple of p at or above 2^58, which makes a group's
    partial non-negative below 2^64), then for g = 1, 2 the value
    w = 2^(40 g) mod p and its Shoup constant floor(w 2^64 / p) (the groups
    of planes 5-9 and 10-14).  The residue of group g's partial times
    2^(40 g) mod p is a Shoup product by them, canonical (w < p)."""
    ps = [int(v) for v in np.asarray(moduli, dtype=np.uint64).reshape(-1)]
    rows = [[-(-FOLD_BOUND // q) * q for q in ps]]
    for g in range(1, FOLD_GROUPS):
        w = [pow(2, 8 * FOLD_PLANES * g, q) for q in ps]
        rows += [w, [(wl << 64) // q for wl, q in zip(w, ps)]]
    return np.array([v for row in rows for v in row], dtype=np.uint64)


def _host_counts(w_dig, tables: MxuNttTables) -> np.ndarray:
    """The counts as the int64 [2L] host array the kernel reads (the weight
    counts, then the data counts), kept on the tables so that its pointer
    stays valid while the tables live."""
    cache = tables.__dict__.setdefault("_host_counts", {})
    key = limb_counts(w_dig, tables)
    if key not in cache:
        cache[key] = np.array(key[0] + key[1], dtype=np.int64)
    return cache[key]


def mxu_pass(x, w_dig, tables: MxuNttTables, contract_x: str, twist=None):
    """One modular matmul pass of the four-step transform (kernel
    ``ntt_mxu``): out = W x (contract_x 'A', the data's N1 axis) or x W^T
    ('B', its N2 axis) mod p, per limb, canonical, then times the twist
    (twist = (w, w_shoup), int64 [L, N1, N2]) with a canonical Shoup
    multiply when given.

    x: int64 [..., L, N1, N2] in [0, 2p); w_dig: the pass's int8 digit
    planes [L, DW, K, K] of ``tables``."""
    if contract_x not in ("A", "B"):
        raise ValueError(f"ntt_mxu: contract_x must be 'A' or 'B', not {contract_x!r}")
    if not is_cuda(x, w_dig, tables.modulus):
        return mxu_pass_plain(x, w_dig, tables, contract_x, twist)
    n1, n2 = tables.n1, tables.n2
    L = tables.modulus.numel()
    if x.dim() < 3 or tuple(x.shape[-3:]) != (L, n1, n2):
        raise ValueError(f"ntt_mxu: expected [..., {L}, {n1}, {n2}], got {tuple(x.shape)}")
    side = n1 if contract_x == "A" else n2
    other = n2 if contract_x == "A" else n1
    dw, dx = tables.ndig_w, tables.ndig_x
    if tuple(w_dig.shape) != (L, dw, side, side):
        raise ValueError(f"ntt_mxu: digit planes {tuple(w_dig.shape)} for pass {contract_x}")
    if dw > KERNEL_DW_MAX or dx > KERNEL_DX_MAX or L > MXU_MAX_L or side > 512 or other < 2:
        raise ValueError(f"ntt_mxu kernel: {dw} weight and {dx} data digits on {L} limbs, K = "
                         f"{side} over {other} columns are outside what it takes (at most 7, 8, "
                         f"{MXU_MAX_L} and 512, at least 2 columns)")
    cuda.check(x, "ntt_mxu input")
    cuda.check(w_dig, "ntt_mxu digit planes", dtype=torch.int8)
    consts = [tables.modulus, tables.ratio1]
    if twist is not None:
        consts += list(twist)
        if any(tuple(t.shape) != (L, n1, n2) for t in twist):
            raise ValueError("ntt_mxu: the twist is [L, N1, N2]")
    for t in consts:
        cuda.check(t, "ntt_mxu table")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if any(t.data_ptr() % 16 for t in [x, out] + list(twist or ())):
        raise ValueError("ntt_mxu: the data, the output and the twist must be 16-byte aligned")
    tw, tws = twist if twist is not None else (None, None)
    fold = cuda.host_memo((tables.modulus,), fold_constants)
    R, mode = x.numel() // (n1 * n2), 0 if contract_x == "A" else 1
    geom = _host_geometry(side, other, R, L, dw, dx, mode, _sms(x.device.index or 0))
    cuda.call("ntt_mxu", cuda.ptr(out), cuda.ptr(x), cuda.ptr(w_dig), cuda.ptr(tw),
              cuda.ptr(tws), cuda.ptr(tables.modulus), cuda.ptr(tables.ratio1), fold.ctypes.data,
              _host_counts(w_dig, tables).ctypes.data, geom.ctypes.data, R, L, side, other, mode,
              dw, dx)
    return out


def ntt_forward_mxu(x, tables: MxuNttTables):
    """Forward negacyclic NTT, canonical [0, p) output.

    x: int64 [..., L, N] in [0, 2p); tables on x's device.  Equal bit for
    bit to ops.ntt.ntt_forward on the same input."""
    batch = tuple(x.shape[:-1])
    xr = x.reshape(batch + (tables.n1, tables.n2))
    t = mxu_pass(xr, tables.fwd_col, tables, "A",
                 twist=(tables.fwd_twist, tables.fwd_twist_shoup))
    out = mxu_pass(t, tables.fwd_row, tables, "B")
    return out.reshape(batch + (tables.n,))


def ntt_inverse_mxu(x, tables: MxuNttTables):
    """Inverse negacyclic NTT, canonical [0, p) output.

    x: int64 [..., L, N] in [0, 2p); tables on x's device.  Equal bit for
    bit to ops.ntt.ntt_inverse on the same input."""
    batch = tuple(x.shape[:-1])
    xr = x.reshape(batch + (tables.n1, tables.n2))
    v = mxu_pass(xr, tables.inv_row, tables, "B",
                 twist=(tables.inv_twist, tables.inv_twist_shoup))
    out = mxu_pass(v, tables.inv_col, tables, "A")
    return out.reshape(batch + (tables.n,))
