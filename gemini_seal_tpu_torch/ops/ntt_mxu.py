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
- :func:`ntt_forward_mxu`, :func:`ntt_inverse_mxu`: :370-404, two launches
  each.

On a CPU tensor :func:`mxu_pass` runs its plain version, the JAX arithmetic
step by step; on a CUDA tensor it launches the kernel, whose digit-pair
products run on the int8 tensor cores.  Its floor on an H100 (700 W) is the
tensor cores' 989.5e12 int8 MACs/s: 49 digit pairs x N1 x N1 x N2 (pass A)
or N1 x N2 x N2 (pass B) MACs a poly-limb row, 0.16 ms a pass at N=16384
on 1,536 rows (six primes, batch 128 x 2), above its 0.06 ms of bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..modulus import Modulus
from ..utils import numth
from . import cuda, modops
from .backend import is_cuda, resolve_device, to_tensor

__all__ = ["MxuNttTables", "build_mxu_ntt_tables", "ntt_forward_mxu", "ntt_inverse_mxu",
           "mxu_pass", "mxu_pass_plain"]

U64 = 0xFFFFFFFFFFFFFFFF
DIGIT_BITS = 8
BASE = 1 << DIGIT_BITS
# the carry-free lane offset 0x80..80 of the data split, as an int64 bit pattern
_LANE_OFFSET = int("80" * 8, 16) - (1 << 64)
# the kernel's digit counts: DW weight digits, DX = DW or DW + 1 data digits
# (the data's digits cover [0, 2p), at most one more than p's)
KERNEL_DW = range(2, 8)


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

    return MxuNttTables(
        n=n, n1=n1, n2=n2, moduli=mods, ndig_w=ndig_w, ndig_x=ndig_x,
        fwd_col=i8(fwd_col), fwd_row=i8(fwd_row),
        fwd_twist=to_tensor(fwd_twist, dev), fwd_twist_shoup=to_tensor(fwd_twist_s, dev),
        inv_col=i8(inv_col), inv_row=i8(inv_row),
        inv_twist=to_tensor(inv_twist, dev), inv_twist_shoup=to_tensor(inv_twist_s, dev),
        modulus=to_tensor(np.array(mods, dtype=np.uint64), dev),
        ratio0=to_tensor(ratio0, dev), ratio1=to_tensor(ratio1, dev),
        neg_offset=to_tensor(neg_off, dev),
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
    dw, dx = tables.ndig_w, tables.ndig_x
    if tuple(w_dig.shape) != (L, dw, side, side):
        raise ValueError(f"ntt_mxu: digit planes {tuple(w_dig.shape)} for pass {contract_x}")
    if dw not in KERNEL_DW or dx not in (dw, dw + 1):
        raise ValueError(f"ntt_mxu kernel: {dw} weight and {dx} data digits are outside "
                         f"its instantiations (2-7, and DW or DW + 1)")
    cuda.check(x, "ntt_mxu input")
    cuda.check(w_dig, "ntt_mxu digit planes", dtype=torch.int8)
    consts = [tables.modulus, tables.ratio0, tables.ratio1, tables.neg_offset]
    if twist is not None:
        consts += list(twist)
        if any(tuple(t.shape) != (L, n1, n2) for t in twist):
            raise ValueError("ntt_mxu: the twist is [L, N1, N2]")
    for t in consts:
        cuda.check(t, "ntt_mxu table")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tw, tws = twist if twist is not None else (None, None)
    cuda.call("ntt_mxu", cuda.ptr(out), cuda.ptr(x), cuda.ptr(w_dig), cuda.ptr(tw),
              cuda.ptr(tws), *(cuda.ptr(t) for t in consts[:4]),
              x.numel() // (n1 * n2), L, side, n2 if contract_x == "A" else n1,
              0 if contract_x == "A" else 1, dw, dx)
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
