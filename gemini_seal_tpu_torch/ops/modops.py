"""64-bit modular arithmetic on the int64 residue substrate.

Port of gemini_seal_tpu/ops/modops.py (the reference's Barrett/Shoup
single-word modmul library, native/src/seal/util/uintarithsmallmod.h).
The plain versions below are PyTorch on int64 tensors holding u64 bit
patterns (see :mod:`.backend`): a logical right shift is an arithmetic
shift then a mask, an unsigned compare is a signed compare after XOR with
1<<63, and products wrap like u64.  They are bit-identical to the JAX
functions, lazy ranges included:
  - mul_mod_shoup_lazy: output in [0, 2p) for any 64-bit x, w < p
  - mul_mod_shoup: the same product reduced once, output in [0, p)
  - barrett_reduce_128/64: output in [0, p)

On the card the same arithmetic runs inside the kernels (csrc/modops.cuh).
This module also holds the wrappers of the two kernels built from it:

- :func:`contract_mulmod_128` (kernel ``contract``): the 128-bit-exact
  multiply-accumulate contraction behind accumulate_mulmod_128's call
  sites (mod-up, key inner product, _dot_mod_128, the weighted sums), with
  its launch geometry :func:`contract_geometry`;
- :func:`rns_elementwise` (kernel ``elementwise``): the per-limb
  add/sub/neg/mul_mod chains of the ring ops and of the fused mod-down,
  and the Barrett-64 reduction of modulo_poly_coeffs (its ``reduce64``
  mode).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda
from .backend import is_cuda

__all__ = [
    "shr",
    "ult",
    "uge",
    "mul64_wide",
    "mulhi64",
    "add128",
    "barrett_reduce_128",
    "divmod_128",
    "barrett_reduce_64",
    "mul_mod",
    "mul_mod_shoup_lazy",
    "mul_mod_shoup",
    "add_mod",
    "sub_mod",
    "neg_mod",
    "reduce_once",
    "reduce_twice",
    "accumulate_mulmod_128",
    "contract_mulmod_128",
    "contract_plain",
    "contract_geometry",
    "rns_elementwise",
    "elementwise_plain",
    "OPS",
]

_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def shr(x, k: int):
    """Logical right shift of u64 bit patterns held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b):
    """Unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def uge(a, b):
    """Unsigned a >= b."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def _where(c, x, y):
    return torch.where(c, x, y)


def mul64_wide(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) (util/uintarith.h:802)."""
    a_lo = a & _MASK32
    a_hi = shr(a, 32)
    b_lo = b & _MASK32
    b_hi = shr(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = shr(ll, 32) + (lh & _MASK32) + (hl & _MASK32)
    lo = (mid << 32) | (ll & _MASK32)
    hi = hh + shr(lh, 32) + shr(hl, 32) + shr(mid, 32)
    return hi, lo


def mulhi64(a, b):
    """High 64 bits of the 128-bit product."""
    return mul64_wide(a, b)[0]


def add128(hi_a, lo_a, hi_b, lo_b):
    """(hi_a:lo_a) + (hi_b:lo_b) mod 2^128 as (hi, lo)."""
    lo = lo_a + lo_b
    return hi_a + hi_b + ult(lo, lo_a).long(), lo


def _barrett_quotient(hi, lo, ratio0, ratio1):
    """The Barrett estimate of floor((hi:lo) / p), at most one below it
    (uintarithsmallmod.h:140-171)."""
    carry = mulhi64(lo, ratio0)
    t2_hi, t2_lo = mul64_wide(lo, ratio1)
    tmp1 = t2_lo + carry
    tmp3 = t2_hi + ult(tmp1, t2_lo).long()
    t2_hi, t2_lo = mul64_wide(hi, ratio0)
    tmp1b = tmp1 + t2_lo
    carry2 = t2_hi + ult(tmp1b, tmp1).long()
    return hi * ratio1 + tmp3 + carry2


def barrett_reduce_128(hi, lo, p, ratio0, ratio1):
    """[0, 2^128) -> [0, p) Barrett reduction (uintarithsmallmod.h:140-178),
    the same step sequence as the JAX function."""
    result = lo - _barrett_quotient(hi, lo, ratio0, ratio1) * p
    return _where(uge(result, p), result - p, result)


def divmod_128(hi, lo, p, ratio0, ratio1):
    """floor((hi:lo) / p) and the remainder; the quotient must fit in 64
    bits.  The Barrett estimate with the quotient corrected and returned
    (BFV plain scaling, scalingvariant.cpp:40-44 divide_uint128_inplace)."""
    q = _barrett_quotient(hi, lo, ratio0, ratio1)
    r = lo - q * p
    fix = uge(r, p)
    return q + fix.long(), _where(fix, r - p, r)


def barrett_reduce_64(x, p, ratio1):
    """[0, 2^64) -> [0, p) single-word Barrett (inputs < 2^63 as in the
    reference's barrett_reduce_63 contract)."""
    q = mulhi64(x, ratio1)
    result = x - q * p
    return _where(uge(result, p), result - p, result)


def mul_mod(a, b, p, ratio0, ratio1):
    """a * b mod p via Barrett."""
    hi, lo = mul64_wide(a, b)
    return barrett_reduce_128(hi, lo, p, ratio0, ratio1)


def mul_mod_shoup_lazy(x, w, w_shoup, p):
    """x * w mod p in [0, 2p) given w_shoup = floor(w * 2^64 / p)."""
    q = mulhi64(x, w_shoup)
    return x * w - q * p


def mul_mod_shoup(x, w, w_shoup, p):
    """Canonical-output Shoup multiplication: x * w mod p in [0, p)
    (the JAX mul_mod_shoup, ops/modops.py:184-190)."""
    r = mul_mod_shoup_lazy(x, w, w_shoup, p)
    return _where(uge(r, p), r - p, r)


def add_mod(a, b, p):
    s = a + b
    return _where(uge(s, p), s - p, s)


def sub_mod(a, b, p):
    d = a - b
    return _where(ult(a, b), d + p, d)


def neg_mod(a, p):
    return _where(a == 0, a, p - a)


def reduce_once(x, p):
    """[0, 2p) -> [0, p)."""
    return _where(uge(x, p), x - p, x)


def reduce_twice(x, p):
    """[0, 4p) -> [0, p)."""
    return reduce_once(reduce_once(x, p * 2), p)


def accumulate_mulmod_128(pairs, p, ratio0, ratio1):
    """sum_k a_k * b_k mod p with exact 128-bit accumulation.

    The JAX function's digit-plane form: each 128-bit partial product is
    split into four 32-bit planes summed in 64 bits (exact for <= 2^26
    terms), renormalized once and Barrett-reduced.
    """
    l0 = l1 = l2 = l3 = None
    for a, b in pairs:
        hi, lo = mul64_wide(a, b)
        if l0 is None:
            l0, l1 = lo & _MASK32, shr(lo, 32)
            l2, l3 = hi & _MASK32, shr(hi, 32)
        else:
            l0 = l0 + (lo & _MASK32)
            l1 = l1 + shr(lo, 32)
            l2 = l2 + (hi & _MASK32)
            l3 = l3 + shr(hi, 32)
    s1 = l1 + shr(l0, 32)
    s2 = l2 + shr(s1, 32)
    s3 = l3 + shr(s2, 32)
    return barrett_reduce_128(
        (s2 & _MASK32) | (s3 << 32), (l0 & _MASK32) | (s1 << 32),
        p, ratio0, ratio1,
    )


# --------------------------------------------------------------------------
# kernel `contract`: 128-bit multiply-accumulate contraction
# --------------------------------------------------------------------------

def _contract_shapes(a, w):
    if a.dim() < 4 or w.dim() != 4:
        raise ValueError("contract: a is [..., G, K, Ja, N], w is [G, K, J, Nw]")
    G, K, J, Nw = w.shape
    Ga, Ka, Ja, N = a.shape[-4:]
    if Ga not in (1, G) or Ka != K or Ja not in (1, J) or Nw not in (1, N):
        raise ValueError(f"contract: shapes {tuple(a.shape)} and {tuple(w.shape)} do not match")
    return G, K, J, Ja, N, Nw


def contract_plain(a, w, p, ratio0, ratio1, prescale=None):
    """Plain version of :func:`contract_mulmod_128`."""
    G, K, J, _, _, _ = _contract_shapes(a, w)
    if prescale is not None:
        s, sp, sr0, sr1 = (v.reshape(G, K, 1, 1) for v in prescale)
        a = mul_mod(a, s, sp, sr0, sr1)
    pj, r0, r1 = (v.reshape(J, 1) for v in (p, ratio0, ratio1))
    return accumulate_mulmod_128(
        ((a[..., k, :, :], w[:, k]) for k in range(K)), pj, r0, r1)


# the contraction's launch geometry (csrc/contract.cu)
_TILE_MIN = 8           # column units a tile keeps while it can: 64-128 contiguous bytes a row
_THREADS_MAX = 256
_STAGE_MAX = 32 * 1024  # bytes of staged inputs a CTA
_SMEM_MAX = 48 * 1024   # bytes of shared memory a CTA: moduli, weights, stage
_FILL = 132 * 1024      # threads that keep every SM of the H100 busy
_GRID_YZ = 65535


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def contract_geometry(R, Ga, G, K, J, Ja, N, Nw, prescale: bool, vec: int,
                      shoup: Optional[bool] = None) -> dict:
    """The launch geometry of one ``contract`` call, picked by shape.

    A CTA owns a tile of ``tile`` column units (``vec`` coefficients each)
    of one row r and one input group z (``z_count`` of them); its
    ``threads`` threads compute the ``ng`` x J output items of each unit.
    ``ng`` = G in broadcast mode without a pre-scale (one input for every
    group), else 1.  Where an input feeds several outputs (broadcast, or
    Ja = 1 with J > 1) the CTA stages the tile's K x Ja input rows once
    (pre-scaled once) in shared memory (``staged``); else the items read
    their inputs directly.  The output moduli and the Nw = 1 weights share
    the CTA's shared memory with the stage.  The tile is as wide as the
    stage allows, and narrowed while a call has too few threads to fill the
    card and each thread still has more than one item: a call of one row
    then spreads its outputs over threads of their own.  A call of more
    than two waves of threads pre-scales by Shoup constants that each CTA
    computes once (``shoup``); a smaller one by the Barrett mul_mod, which
    needs no set-up before the first load.  ``shoup`` True or False forces
    one of the two (port_tools/contract_prescale.py times both).
    """
    units = N // vec
    shared = Ga == 1 and G > 1 and not prescale
    ng = G if shared else 1
    z_count = 1 if shared else G
    staged = ng > 1 or (Ja == 1 and J > 1)
    if z_count > _GRID_YZ:
        raise ValueError(f"contract: {G} groups exceed the grid")
    if max(G * J, K * Ja * Ga, G * K * J if Nw > 1 else 0) * N >= 1 << 31:
        raise ValueError("contract: a row's offsets exceed 32 bits")

    def fixed(shoup):
        return (3 * J + (0 if Nw > 1 else G * K * J) + (3 * K if shoup else 0) + 1) // 2 * 16

    budget = min(_STAGE_MAX, _SMEM_MAX - fixed(prescale))

    def stage(tp):
        return K * Ja * tp * vec * 8 if staged else 0

    def threads(tp):
        return min(_THREADS_MAX, max(32, _pow2_ceil(ng * J * tp)))

    tile = min(_THREADS_MAX, _pow2_ceil(units))
    while tile > 1 and stage(tile) > budget:
        tile //= 2
    if stage(tile) > budget:
        raise ValueError(f"contract: {K} x {Ja} input rows and {G} x {K} x {J} weights "
                         "exceed a CTA's shared memory")
    while (tile > _TILE_MIN and ng * J * tile > _THREADS_MAX
           and R * z_count * -(-units // tile) * _THREADS_MAX < _FILL):
        tile //= 2
    tiles = -(-units // tile)
    if shoup is None:
        shoup = R * z_count * tiles * threads(tile) > 2 * _FILL
    shoup = prescale and shoup
    return {"vec": vec, "tile": tile, "log_tp": tile.bit_length() - 1,
            "threads": threads(tile), "tiles": tiles, "z_count": z_count, "ng": ng,
            "grid_y": min(R, _GRID_YZ), "staged": int(staged), "shoup": int(shoup),
            "smem": fixed(shoup) + stage(tile)}


def contract_mulmod_128(a, w, p, ratio0, ratio1, prescale=None):
    """out[..., g, j, n] = sum_k A'[..., g|0, k, j|0, n] * W[g, k, j, n|0] mod p_j.

    a: [..., Ga, K, Ja, N] with Ga in {1, G} (one input broadcast over the
    groups, read in place: the kernel's ``broadcast`` mode) and Ja in {1, J};
    w: [G, K, J, Nw] with Nw in {1, N} (per-limb constant weights, or
    per-coefficient key rows);
    p/ratio0/ratio1: [J] (any shape of J elements).  ``prescale`` =
    (s, q, q_r0, q_r1), each [G, K]: A' = A * s mod q first (the mod-up's
    punctured-inverse multiply and the mod-down's inv_hat multiply).
    Exact in 128 bits, then one Barrett: canonical output, equal to the JAX
    digit-plane sum whenever that sum is below 2^128.
    """
    if not is_cuda(a, w, p):
        return contract_plain(a, w, p, ratio0, ratio1, prescale)
    G, K, J, Ja, N, Nw = _contract_shapes(a, w)
    Ga = a.shape[-4]
    consts = [p, ratio0, ratio1] + (list(prescale) if prescale is not None else [])
    for t, what in [(a, "contract a"), (w, "contract w")] + [(c, "contract const") for c in consts]:
        cuda.check(t, what)
    if p.numel() != J or (prescale is not None and any(v.numel() != G * K for v in prescale)):
        raise ValueError("contract: constant sizes do not match the weights")
    R = a.numel() // (Ga * K * Ja * N)
    out = torch.empty(a.shape[:-4] + (G, J, N), dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    vec = 2 if N % 2 == 0 and all(t.data_ptr() % 16 == 0 for t in (a, w, out)) else 1
    geo = contract_geometry(R, Ga, G, K, J, Ja, N, Nw, prescale is not None, vec)
    s = prescale if prescale is not None else (None, None, None, None)
    broadcast = Ga == 1 and G > 1
    cuda.call("contract", cuda.ptr(out), cuda.ptr(a), cuda.ptr(w),
              cuda.ptr(p), cuda.ptr(ratio0), cuda.ptr(ratio1),
              cuda.ptr(s[0]), cuda.ptr(s[1]), cuda.ptr(s[2]), cuda.ptr(s[3]),
              R, G, Ga, K, J, Ja, N, int(Nw > 1), vec, geo["log_tp"], geo["threads"],
              geo["z_count"], geo["ng"], geo["grid_y"], geo["staged"], geo["shoup"],
              geo["smem"],
              mode="broadcast" if broadcast else None)
    return out


# --------------------------------------------------------------------------
# kernel `elementwise`: per-limb modular ops over [..., L, N]
# --------------------------------------------------------------------------

# op codes shared with csrc/elementwise.cu
OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3, "muladd": 4, "addmul": 5,
       "barrett64": 6, "submul": 7, "reduce64": 8}


def elementwise_plain(op, a, p, ratio0, ratio1, b=None, s=None):
    """Plain version of :func:`rns_elementwise` (constants shaped [L, 1])."""
    if op == "add":
        return add_mod(a, b, p)
    if op == "sub":
        return sub_mod(a, b, p)
    if op == "neg":
        return neg_mod(a, p)
    if op == "mul":
        return mul_mod(a, b, p, ratio0, ratio1)
    if op == "muladd":
        return add_mod(b, mul_mod(a, s, p, ratio0, ratio1), p)
    if op == "addmul":
        return mul_mod(add_mod(a, b, p), s, p, ratio0, ratio1)
    if op == "barrett64":
        return barrett_reduce_64(a + b, p, ratio1)
    if op == "submul":
        return mul_mod(a + (p - b), s, p, ratio0, ratio1)
    if op == "reduce64":
        return barrett_reduce_64(a, p, ratio1)
    raise ValueError(f"unknown elementwise op {op!r}")


def rns_elementwise(op: str, a, p, ratio0, ratio1, b=None, s=None):
    """Per-limb modular op over a: [..., L, N], moduli p/ratio0/ratio1 [L, 1].

    b is a tensor broadcast over a's leading axes ([..., L, N] trailing
    shape of a) or a per-limb constant [L, 1]; s is a per-limb constant.
      add: a + b    sub: a - b    neg: -a    mul: a * b
      muladd: a * s + b    addmul: (a + b) * s    barrett64: (a + b) mod p
      submul: (a - b) * s    reduce64: a mod p (no b; a < 2^63)
    (barrett64 is the u64 add then barrett_reduce_64, as the rounding step
    of divide_and_round_q_last_ntt computes it; submul is the u64
    a + (p - b) then one full-range mul_mod, as fast_floor computes it, so
    for b < p it equals sub_mod then mul_mod: both outputs are canonical).
    """
    tensors = [t for t in (a, b, s, p) if t is not None]
    if not is_cuda(*tensors):
        return elementwise_plain(op, a, p, ratio0, ratio1, b, s)
    if op not in OPS:
        raise ValueError(f"unknown elementwise op {op!r}")
    if a.dim() < 2:
        raise ValueError("elementwise: a must be [..., L, N]")
    L, N = a.shape[-2:]
    if p.numel() != L:
        raise ValueError("elementwise: modulus count does not match the limb axis")
    b_full = b_const = None
    if b is not None:
        if b.shape == (L, 1) and N != 1:
            b_const = b
        elif tuple(b.shape) == tuple(a.shape[a.dim() - b.dim():]):
            b_full = b
        else:
            raise ValueError(f"elementwise: b {tuple(b.shape)} does not broadcast to a {tuple(a.shape)}")
    elif op not in ("neg", "reduce64"):
        raise ValueError(f"elementwise {op}: b is required")
    if op in ("muladd", "addmul", "submul") and (s is None or s.numel() != L):
        raise ValueError(f"elementwise {op}: s must be a per-limb constant")
    for t, what in ((a, "a"), (b, "b"), (s, "s"), (p, "p"), (ratio0, "ratio0"), (ratio1, "ratio1")):
        if t is not None:
            cuda.check(t, f"elementwise {what}")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    cuda.call("elementwise", cuda.ptr(out), cuda.ptr(a), cuda.ptr(b_full),
              0 if b_full is None else b_full.numel(), cuda.ptr(b_const),
              cuda.ptr(s), cuda.ptr(p), cuda.ptr(ratio0), cuda.ptr(ratio1),
              a.numel(), L, N, OPS[op], mode="reduce64" if op == "reduce64" else None)
    return out
