"""Coefficient-wise polynomial ops over [..., L, N] residue tensors.

Port of gemini_seal_tpu/ops/dyadic.py (the reference's
polyarithsmallmod.{h,cpp} loops).  Each op broadcasts per-limb constants
shaped [L, 1] against data [..., L, N].  On the card the ring ops and
:func:`modulo_poly_coeffs` are one launch of the ``elementwise`` kernel
(csrc/elementwise.cu), :func:`negacyclic_shift_poly` and
:func:`negacyclic_mono_mul_poly` one launch of ``negacyclic``
(csrc/negacyclic.cu: one thread an output, rows and tiles on the grid's x
axis and limbs on y, the moduli and the monomial's constants by value, a
scalar's as Shoup constants; :func:`negacyclic_geometry`) and
:func:`poly_infty_norm` one launch of
``infty_norm`` (csrc/infty_norm.cu: a row over a cluster of CTAs reduced
through distributed shared memory, the moduli by value;
:func:`infty_norm_geometry`); on the CPU each runs its plain
version (:func:`negacyclic_plain`, :func:`infty_norm_plain` and the modops
chains).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..modulus import Modulus
from . import cuda
from .backend import is_cuda
from .modops import _pow2_ceil, mul_mod, neg_mod, rns_elementwise

__all__ = [
    "LimbConstants",
    "add_poly",
    "sub_poly",
    "negate_poly",
    "multiply_poly_scalar",
    "dyadic_product",
    "modulo_poly_coeffs",
    "negacyclic_shift_poly",
    "negacyclic_mono_mul_poly",
    "poly_infty_norm",
    "negacyclic_plain",
    "negacyclic_constants",
    "negacyclic_geometry",
    "NEGACYCLIC_MAX_L",
    "infty_norm_plain",
    "infty_norm_geometry",
    "INFTY_NORM_MAX_L",
]


@dataclass(frozen=True)
class LimbConstants:
    """Per-limb modulus constants, broadcast-ready against [..., L, N].

    p, ratio0, ratio1: int64[L, 1] tensors holding u64 values
    (floor(2^128/p) low/high words — reference: modulus.h:122-129).
    """

    p: torch.Tensor
    ratio0: torch.Tensor
    ratio1: torch.Tensor

    @staticmethod
    def from_moduli(moduli, device) -> "LimbConstants":
        mods = [m if isinstance(m, Modulus) else Modulus(int(m)) for m in moduli]

        def col(vals):
            a = np.array(vals, dtype=np.uint64).reshape(-1, 1)
            return torch.from_numpy(a.view(np.int64).copy()).to(device)

        return LimbConstants(
            p=col([m.value for m in mods]),
            ratio0=col([m.const_ratio[0] for m in mods]),
            ratio1=col([m.const_ratio[1] for m in mods]),
        )

    def slice(self, lo: int, hi: int) -> "LimbConstants":
        return LimbConstants(self.p[lo:hi], self.ratio0[lo:hi], self.ratio1[lo:hi])


def _op(op, a, limbs: LimbConstants, b=None, s=None):
    return rns_elementwise(op, a, limbs.p, limbs.ratio0, limbs.ratio1, b=b, s=s)


def add_poly(a, b, limbs: LimbConstants):
    """(a + b) mod q_i per limb (polyarithsmallmod.h:261-360)."""
    return _op("add", a, limbs, b=b)


def sub_poly(a, b, limbs: LimbConstants):
    return _op("sub", a, limbs, b=b)


def negate_poly(a, limbs: LimbConstants):
    return _op("neg", a, limbs)


def multiply_poly_scalar(a, scalar, limbs: LimbConstants):
    """a * s_i mod q_i; scalar is an int64[L, 1] per-limb tensor
    (polyarithsmallmod.h:471-528)."""
    return _op("mul", a, limbs, b=scalar)


def dyadic_product(a, b, limbs: LimbConstants):
    """Hadamard product in NTT domain (polyarithsmallmod.h:530-597)."""
    return _op("mul", a, limbs, b=b)


def modulo_poly_coeffs(a, limbs: LimbConstants):
    """Reduce arbitrary u64 coefficients into [0, q_i) by Barrett-64
    (polyarithsmallmod.h:21-174): the ``elementwise`` kernel's ``reduce64``
    mode.  Valid for inputs < 2^63 (the barrett_reduce_63 contract, as in
    the JAX function)."""
    return _op("reduce64", a, limbs)


def negacyclic_plain(a, shift: int, limbs: LimbConstants, coeff=None):
    """Plain version of the ``negacyclic`` kernel: a (times coeff, when
    given: an int or an int64[L, 1] tensor) times x^shift, with the JAX
    function's roll and sign convention (shift in [0, 2N))."""
    n = a.shape[-1]
    if coeff is not None:
        c = coeff if torch.is_tensor(coeff) else torch.full_like(limbs.p, _i64(coeff))
        a = mul_mod(a, c, limbs.p, limbs.ratio0, limbs.ratio1)
    if shift == 0:
        return a
    rot = shift % n
    rolled = torch.roll(a, rot, dims=-1)
    wrapped = torch.arange(n, device=a.device) < rot
    if (shift // n) % 2 == 1:
        wrapped = ~wrapped  # shifting by n negates everything
    return torch.where(wrapped, neg_mod(rolled, limbs.p), rolled)


def _i64(c: int) -> int:
    """A u64 value as the int64 of the same bit pattern."""
    c = int(c)
    return c - (1 << 64) if c >= 1 << 63 else c


# limbs a launch takes by value (csrc/negacyclic.cu NEGACYCLIC_MAX_L): the
# most a chain may hold (modulus.py COEFF_MOD_COUNT_MAX)
NEGACYCLIC_MAX_L = 64
# the kernel's forms (csrc/negacyclic.cu FORM)
_SHIFT, _BARRETT_LIMB, _SHOUP = range(3)


def negacyclic_constants(p, ratio0, ratio1, coeff=None) -> np.ndarray:
    """The by-value constants of one launch, u64[3L]: the L moduli, then the
    product's two constants a limb: the Barrett ratios (the shift, and a
    per-limb coefficient taken by mul_mod), or, for a scalar u64 coefficient
    c, w = c mod p and its Shoup constant floor(w 2^64 / p), reduced on the
    host: w is below p, which the kernel's one-correction Shoup product
    needs (as check_shoup_operands asks of K6's and K7's multipliers).
    Raises ValueError above NEGACYCLIC_MAX_L limbs."""
    p, r0, r1 = (np.asarray(v, dtype=np.uint64).reshape(-1) for v in (p, ratio0, ratio1))
    L = p.size
    if not 1 <= L <= NEGACYCLIC_MAX_L or r0.size != L or r1.size != L:
        raise ValueError(f"negacyclic: {L} moduli with {r0.size} and {r1.size} ratios "
                         f"(1 to {NEGACYCLIC_MAX_L} moduli, one ratio each)")
    if coeff is None:
        return np.concatenate([p, r0, r1])
    c = int(coeff) % (1 << 64)
    w = [c % int(q) for q in p]
    ws = [(wl << 64) // int(q) for wl, q in zip(w, p)]
    return np.concatenate([p, np.array(w, dtype=np.uint64), np.array(ws, dtype=np.uint64)])


def negacyclic_geometry(N: int) -> dict:
    """The launch geometry of a row of N = 2^log_n outputs: one thread an
    output, 2^``log_tiles`` CTAs of ``threads`` (256, or the row's width
    below it, at least a warp).  port_tools/small_kernels.py --sweep times
    64 and 128 threads against it."""
    threads = min(256, max(32, _pow2_ceil(N)))
    return {"threads": threads, "log_tiles": max(0, (N // threads).bit_length() - 1)}


def _negacyclic(a, shift: int, limbs: LimbConstants, coeff=None):
    n = a.shape[-1]
    shift = int(shift) % (2 * n)
    tensors = [a, limbs.p] + ([coeff] if torch.is_tensor(coeff) else [])
    if not is_cuda(*tensors):
        return negacyclic_plain(a, shift, limbs, coeff)
    if coeff is None and shift == 0:
        return a
    if a.dim() < 2 or n & (n - 1) or n > 1 << 17:
        raise ValueError(f"negacyclic: expected [..., L, N] with N a power of two up to "
                         f"2^17, got {tuple(a.shape)}")
    L = a.shape[-2]
    if limbs.p.numel() != L:
        raise ValueError("negacyclic: modulus count does not match the limb axis")
    if L > NEGACYCLIC_MAX_L:
        raise ValueError(f"negacyclic: {L} limbs exceed the {NEGACYCLIC_MAX_L} a launch takes")
    if torch.is_tensor(coeff) and coeff.numel() != L:
        raise ValueError("negacyclic: the coefficient must be a scalar or [L, 1]")
    for t, what in ((a, "a"), (limbs.p, "p"), (limbs.ratio0, "ratio0"),
                    (limbs.ratio1, "ratio1")):
        cuda.check(t, f"negacyclic {what}")
    if torch.is_tensor(coeff):
        cuda.check(coeff, "negacyclic coefficient")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    if a.numel() >= 1 << 31:
        raise ValueError("negacyclic: the tensor exceeds 2^31 words (32-bit offsets)")
    consts = cuda.host_memo((limbs.p, limbs.ratio0, limbs.ratio1), negacyclic_constants)
    if coeff is None:
        form = _SHIFT
    elif torch.is_tensor(coeff):
        form = _BARRETT_LIMB
    else:
        form = _SHOUP
        consts = negacyclic_constants(consts[:L], consts[L:2 * L], consts[2 * L:], coeff)
    geo = negacyclic_geometry(n)
    cuda.call("negacyclic", cuda.ptr(out), cuda.ptr(a),
              cuda.ptr(coeff) if form == _BARRETT_LIMB else 0, consts.ctypes.data, form,
              a.numel() // (L * n), L, n.bit_length() - 1, shift, geo["threads"],
              geo["log_tiles"], mode="shift" if coeff is None else "mono_mul")
    return out


def negacyclic_shift_poly(a, shift: int, limbs: LimbConstants):
    """Multiply by x^shift in R_q = Z_q[X]/(X^N+1)
    (polyarithsmallmod.h:601-657): a rotation of the coefficient axis with
    a sign flip on wrap-around (the ``negacyclic`` kernel's ``shift``
    mode).  `shift` is a Python int; a multiple of 2N returns `a` itself,
    as the JAX function does."""
    return _negacyclic(a, shift, limbs)


def negacyclic_mono_mul_poly(a, mono_coeff, mono_exponent: int, limbs: LimbConstants):
    """a * (c * x^e) in R_q (polyarithsmallmod.h:659-804): the ``negacyclic``
    kernel's ``mono_mul`` mode, one launch for the multiply, the roll and
    the signs.  mono_coeff is a u64 Python int (one value for every limb) or
    an int64[L, 1] per-limb tensor on a's device; it may exceed q_i (a CRT
    residue, or the fast plain lift's q_i - t + c < 2 q_i).  The kernel
    multiplies by a tensor with the full 128-bit Barrett mul_mod, as the JAX
    function does, and by a scalar with the Shoup product by c mod q_i that
    the host computes: the same canonical value."""
    return _negacyclic(a, mono_exponent, limbs, mono_coeff)


def infty_norm_plain(a, limbs: LimbConstants):
    """Plain version of the ``infty_norm`` kernel.  The compare is int64,
    exact for residues below p (< 2^61), the function's contract."""
    p = limbs.p
    mag = torch.where(a > (p >> 1), p - a, a)
    return torch.amax(mag, dim=-1)


# limbs a launch takes by value and CTAs a row's cluster spans
# (csrc/infty_norm.cu INFTY_NORM_MAX_L, INFTY_NORM_MAX_CLUSTER)
INFTY_NORM_MAX_L = 64
INFTY_NORM_MAX_CLUSTER = 8


def _host_moduli(p) -> np.ndarray:
    """The moduli a launch of ``infty_norm`` takes by value (host u64)."""
    return np.ascontiguousarray(p, dtype=np.uint64)


def infty_norm_geometry(N: int, rows: int = 1) -> dict:
    """The launch geometry of `rows` rows of N = 2^log_n coefficients: a
    cluster of 2^``log_tiles`` CTAs a row (at most 8, as many as bring the
    call to about two CTAs an SM, no more than the row fills) of
    ``threads`` (N / 16 within 32-256), each thread reading two coefficients
    (16 bytes) a step for ``iters`` steps.  Thread t of CTA ``tile`` reads
    coefficients 2 (s T C + tile T + t) and the next, T threads and C CTAs a
    row, at step s: every coefficient once."""
    threads = min(256, max(32, N // 16))
    want = max(1, 2 * 132 // max(1, rows))
    tiles = min(INFTY_NORM_MAX_CLUSTER, 1 << (want.bit_length() - 1),
                max(1, N // (2 * threads)))
    return {"threads": threads, "log_tiles": tiles.bit_length() - 1,
            "iters": -(-N // (2 * threads * tiles))}


def poly_infty_norm(a, limbs: LimbConstants):
    """Max |a_i| under the centred lift per limb (polyarithsmallmod.h:599):
    int64[..., L, N] residues in [0, q_i) -> int64[..., L], one launch of the
    ``infty_norm`` kernel (a cluster of CTAs a row where the rows are few,
    :func:`infty_norm_geometry`; the moduli by value)."""
    if not is_cuda(a, limbs.p):
        return infty_norm_plain(a, limbs)
    if a.dim() < 2:
        raise ValueError(f"infty_norm: expected [..., L, N], got {tuple(a.shape)}")
    L, n = a.shape[-2:]
    if n < 2 or n & (n - 1) or n > 1 << 17:
        raise ValueError(f"infty_norm: expected N a power of two from 2 to 2^17, got {n}")
    if limbs.p.numel() != L:
        raise ValueError("infty_norm: modulus count does not match the limb axis")
    if L > INFTY_NORM_MAX_L:
        raise ValueError(f"infty_norm: {L} limbs exceed the {INFTY_NORM_MAX_L} a launch takes")
    cuda.check(a, "infty_norm a")
    cuda.check(limbs.p, "infty_norm p")
    out = torch.empty(a.shape[:-1], dtype=torch.int64, device=a.device)
    if a.numel() == 0:
        return out
    if a.data_ptr() % 16:
        raise ValueError("infty_norm: the input must be 16-byte aligned (two coefficients a load)")
    mods = cuda.host_memo((limbs.p,), _host_moduli)
    R = a.numel() // (L * n)
    geo = infty_norm_geometry(n, R * L)
    cuda.call("infty_norm", cuda.ptr(out), cuda.ptr(a), mods.ctypes.data, R, L,
              n.bit_length() - 1, geo["threads"], geo["log_tiles"], geo["iters"])
    return out
