"""Device RNS operations: base conversion, BEHZ, scale-and-round, limb drops.

Port of gemini_seal_tpu/ops/rnsops.py (the reference's RNSTool and
BaseConverter runtime ops, rns.cpp:452-1126).  Every modular-arithmetic
stage is a launch of a hand-written kernel:

- a base conversion (``fast_convert_array``, ``_dot_mod_128``) is one
  ``contract`` launch, the punctured-inverse multiply folded in as its
  pre-scale; a converter fused with the per-limb multiply before it (the
  m_tilde premultiply of ``fastbconv_m_tilde``, |gamma t|_q of
  ``decrypt_scale_and_round``) folds the product of the two multipliers
  into the pre-scale: two canonical mul_mods equal one by the product;
  conversions from one input base are stacked into one launch (rows are
  independent);
- ``sm_mrq`` and the Shenoy-Kumaresan tail of ``fastbconv_sk`` are the two
  modes of the ``behz`` kernel (csrc/behz.cu);
- the plaintext scalings of BFV encryption and the {t, gamma} tail of BFV
  decryption are the modes of the ``scale_round`` kernel
  (csrc/scale_round.cu);
- the limb drops (``divide_and_round_q_last``, ``divide_and_round_multi``,
  ``divide_and_round_q_last_ntt``) are ``contract``, ``elementwise`` and
  ``ntt`` launches.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..tracing import span
from ..utils import numth
from ..utils.rns import BaseConverter, RNSTool
from . import cuda
from .backend import is_cuda, to_numpy, to_tensor
from .dyadic import LimbConstants
from .modops import (_FILL, _GRID_YZ, _pow2_ceil, add_mod, barrett_reduce_64,
                     barrett_reduce_128, contract_mulmod_128, divmod_128, mul64_wide, mul_mod,
                     rns_elementwise, shr, sub_mod, uge, ult)
from .ntt import NTTTables, build_ntt_tables, ntt_forward, ntt_inverse

__all__ = [
    "DeviceBaseConverter",
    "DeviceRNSTool",
    "fast_convert_array",
    "fastbconv_m_tilde",
    "sm_mrq",
    "fast_floor",
    "fastbconv_sk",
    "decrypt_scale_and_round",
    "divide_and_round_q_last",
    "divide_and_round_q_last_ntt",
    "MultiDropPlan",
    "divide_and_round_multi",
    "multiply_add_plain_with_scaling_variant",
    "multiply_sub_plain_with_scaling_variant",
    "plain_scaling_constants",
    "crt_drop_constants",
    "behz",
    "behz_plain",
    "scale_round",
    "scale_round_plain",
    "rns_geometry",
    "shoup_operands",
    "check_shoup_operands",
]

_MASK32 = 0xFFFFFFFF


def _col(vals, device) -> torch.Tensor:
    """u64 values -> int64[len, 1] per-limb constant on `device`."""
    return to_tensor(np.asarray(vals, dtype=np.uint64).reshape(-1, 1), device)


def _dot_mod_128(a, b, obase: LimbConstants, prescale=None):
    """sum_i a[..., i, n] * b[j, i] mod p_j -> [..., O, N].

    a: [..., I, N]; b: int64[O, I].  ``prescale`` = (s, q, q_r0, q_r1),
    each [I]: the inputs are first multiplied by s_i mod q_i (the mul_mod
    that every caller of the JAX function runs just before it).
    """
    O, I = b.shape
    w = b.t().reshape(1, I, O, 1).contiguous()
    a5 = a.reshape(a.shape[:-2] + (1, I, 1, a.shape[-1]))
    if prescale is not None:
        prescale = tuple(v.reshape(1, I) for v in prescale)
    out = contract_mulmod_128(a5, w, obase.p.reshape(-1), obase.ratio0.reshape(-1),
                              obase.ratio1.reshape(-1), prescale=prescale)
    return out.reshape(a.shape[:-2] + (O, a.shape[-1]))


def _slice_tables(t: NTTTables, lo: int, hi: int) -> NTTTables:
    """View of a limb range of stacked NTT tables."""
    return replace(
        t,
        moduli=t.moduli[lo:hi],
        roots=t.roots[lo:hi],
        root_powers=t.root_powers[lo:hi],
        scaled_root_powers=t.scaled_root_powers[lo:hi],
        inv_root_powers=t.inv_root_powers[lo:hi],
        scaled_inv_root_powers=t.scaled_inv_root_powers[lo:hi],
        inv_degree_modulo=t.inv_degree_modulo[lo:hi],
        scaled_inv_degree=t.scaled_inv_degree[lo:hi],
        reduce_precomp=t.reduce_precomp[lo:hi],
        modulus=t.modulus[lo:hi],
    )


def crt_drop_constants(d_moduli, out_moduli):
    """Shared CRT constants for dividing by Q_D = prod(d_moduli) while
    keeping out_moduli: per-d punctured-product inverses, the hat matrix
    (Q_D/d_j) mod q_i, and inv(Q_D) mod q_i (numpy u64)."""
    q_d = 1
    for d in d_moduli:
        q_d *= d
    nd, no = len(d_moduli), len(out_moduli)
    inv_hat = np.zeros(nd, dtype=np.uint64)
    for j, dj in enumerate(d_moduli):
        r = numth.try_invert_uint_mod((q_d // dj) % dj, dj)
        if r is None:
            raise ValueError("drop base: punctured product not invertible")
        inv_hat[j] = r
    hat_qi = np.zeros((no, nd), dtype=np.uint64)
    inv_qd = np.zeros(no, dtype=np.uint64)
    for i, qi in enumerate(out_moduli):
        for j, dj in enumerate(d_moduli):
            hat_qi[i, j] = (q_d // dj) % qi
        r = numth.try_invert_uint_mod(q_d % qi, qi)
        if r is None:
            raise ValueError("drop base: Q_D not invertible")
        inv_qd[i] = r
    return q_d, inv_hat, hat_qi, inv_qd


# --------------------------------------------------------------------------
# base conversion
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceBaseConverter:
    """Device twin of one or more host BaseConverters from one input base:
    one ``contract`` launch.

    ``scale`` [I] multiplies each input limb first (the launch's
    pre-scale): the punctured inverses, times the per-limb multiplier of the
    step that precedes the conversion where one is fused in.
    """

    ibase: LimbConstants
    obase: LimbConstants
    matrix: torch.Tensor   # int64[O, I]
    scale: torch.Tensor    # int64[I]

    @staticmethod
    def from_host(convs, device, multiplier=None, ibase=None) -> "DeviceBaseConverter":
        """Stack host converters that share an input base (their output
        rows one after another); ``multiplier`` [I] (ints) is folded into
        the scale.  ``ibase``, an RNSBase that begins with the converters'
        input base, pads the input with its further limbs at weight and
        scale 0, so that a tensor in that larger base converts without a
        slice."""
        if isinstance(convs, BaseConverter):
            convs = [convs]
        moduli = [m.value for m in convs[0].ibase.base]
        scale = [int(v) for v in convs[0].inv_punctured]
        if multiplier is not None:
            scale = [(s * int(m)) % q for s, m, q in zip(scale, multiplier, moduli)]
        matrix = np.concatenate([c.matrix for c in convs])
        if ibase is not None:
            padded = ibase.values()
            if padded[: len(moduli)] != moduli:
                raise ValueError("ibase must begin with the converters' input base")
            pad = len(padded) - len(moduli)
            matrix = np.pad(matrix, ((0, 0), (0, pad)))
            scale, moduli = scale + [0] * pad, padded
        return DeviceBaseConverter(
            ibase=LimbConstants.from_moduli(moduli, device),
            obase=LimbConstants.from_moduli([m for c in convs for m in c.obase.base], device),
            matrix=to_tensor(matrix, device),
            scale=to_tensor(np.array(scale, dtype=np.uint64), device),
        )


def fast_convert_array(x, conv: DeviceBaseConverter):
    """BEHZ FastBConv: [..., I, N] residues -> [..., O, N]
    (reference: rns.cpp:498-523), one ``contract`` launch."""
    ib = conv.ibase
    return _dot_mod_128(x, conv.matrix, conv.obase,
                        prescale=(conv.scale, ib.p.reshape(-1), ib.ratio0.reshape(-1),
                                  ib.ratio1.reshape(-1)))


# --------------------------------------------------------------------------
# the launch geometry and the Shoup multipliers of `behz` and `scale_round`
# --------------------------------------------------------------------------

def rns_geometry(R: int, L: int, N: int, vec: int, share_rows: bool = False) -> dict:
    """The launch geometry of one ``behz`` or ``scale_round`` call, by shape.

    A thread owns one column unit (``vec`` adjacent coefficients, at most
    the ``vec`` that the pointers allow) of the rows y, y + grid_y, ... and
    computes its output limbs z, z + grid_z, ... (``tiles`` x ``threads``
    units on the grid's x axis).  A row's work is its own in K6 and in
    t_gamma, so every row gets its own y (up to the grid's limit); K7's
    plain modes share a coefficient's rounding fix over the rows and limbs
    (``share_rows``), so a thread keeps ceil(R / grid_y) rows, with grid_y
    as large as it takes to fill the card.  A call whose units of two
    coefficients fill the card (``fills``) takes CTAs of 256 threads and
    one limb group.  A smaller one (the per-op API's one to three
    ciphertexts, an encryption or decryption) is bound by its latency: it
    takes one coefficient a thread, spreads its limbs over grid_z and takes
    CTAs of 128 threads (port_tools/rns_kernels.py timed these picks against
    two coefficients a thread and CTAs of 64 and 256).  ``shoup``: the call
    has more than half a wave of threads, where K6 multiplies by Shoup
    constants that each CTA computes once; a smaller call takes the Barrett
    mul_mod, which needs no set-up and no barrier before its first output
    (port_tools/rns_kernels.py --shoup times the two forms: the Barrett
    form is the faster on the per-op calls at N = 4096, a quarter of a wave
    or less, and the Shoup form at N = 8192, 0.6-0.75 of a wave).
    """
    def rows(units):
        return min(R, _GRID_YZ, -(-_FILL // units) if share_rows else R)

    fills = (N // vec) * rows(N // vec) >= _FILL
    if not fills:
        vec = 1
    units = N // vec
    grid_y = rows(units)
    grid_z = 1 if fills else min(L, _GRID_YZ, -(-_FILL // (units * grid_y)))
    threads = min(256 if fills else 128, max(32, _pow2_ceil(units)))
    tiles = -(-units // threads)
    return {"vec": vec, "threads": threads, "tiles": tiles, "grid_y": grid_y, "grid_z": grid_z,
            "fills": fills, "shoup": int(2 * tiles * threads * grid_y * grid_z > _FILL)}


def _vec(N, *tensors) -> int:
    """2 coefficients a unit (16-byte accesses) when N and every pointer allow."""
    return 2 if N % 2 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def shoup_operands(mode: str, consts) -> list:
    """The (multiplier, modulus) pairs of a packed constant array that the
    kernel multiplies by as Shoup products (each CTA computes their Shoup
    constants): sm_mrq m_tilde^-1 mod p_j and q * m_tilde^-1 mod p_j (the
    product that each CTA forms by mul_mod); sk_tail prod_B and q_l - prod_B
    mod q_l (the u64 difference, as the plain version forms it) and B^-1 mod
    m_sk; t_gamma -q^-1 mod t, -q^-1 mod gamma and gamma^-1 mod t.  The
    plain modes of scale_round have none."""
    k = [int(v) for v in np.asarray(to_numpy(consts), dtype=np.uint64)]
    if mode == "sm_mrq":
        bsk = (len(k) - 1) // 5
        return ([(k[4 * bsk + j], k[j]) for j in range(bsk)]
                + [(k[3 * bsk + j] * k[4 * bsk + j] % k[j], k[j]) for j in range(bsk)])
    if mode == "sk_tail":
        L = (len(k) - 4) // 4
        m_sk = k[4 * L]
        return ([(k[3 * L + l], k[l]) for l in range(L)]
                + [((k[l] - k[3 * L + l]) % (1 << 64), k[l]) for l in range(L)]
                + [(k[4 * L + 3], m_sk)])
    if mode == "t_gamma":
        t, g = k[0], k[3]
        return [(k[6], t), (k[7], g), (k[8], t)]
    if mode in ("plain_add", "plain_sub"):
        return []
    raise ValueError(f"unknown mode {mode!r}")


def check_shoup_operands(mode: str, consts) -> None:
    """Every Shoup multiplier of ``consts`` below its modulus (for sk_tail:
    prod_B mod q_l is not 0), which the kernel's one-correction Shoup
    product assumes."""
    bad = [(w, p) for w, p in shoup_operands(mode, consts) if not w < p]
    if bad:
        raise ValueError(f"{mode}: multipliers not below their moduli: {bad}")


# --------------------------------------------------------------------------
# kernel `behz`: sm_mrq and the Shenoy-Kumaresan tail
# --------------------------------------------------------------------------

BEHZ_MODES = {"sm_mrq": 0, "sk_tail": 1}


def behz_plain(mode, x, consts, aux=None):
    """Plain version of :func:`behz`: the JAX function's steps on the
    packed constants (layout in csrc/behz.cu)."""
    if mode == "sm_mrq":
        bsk = x.shape[-2] - 1
        p, r0, r1, prod_q, inv_mt = (consts[k * bsk:(k + 1) * bsk].reshape(bsk, 1)
                                     for k in range(5))
        inv_q_mt = consts[5 * bsk]
        m_tilde = 1 << 32
        x_bsk, x_mt = x[..., :bsk, :], x[..., bsk, :]
        r = (x_mt * inv_q_mt) & _MASK32
        r = (m_tilde - r) & _MASK32
        r_b = r[..., None, :]
        r_c = torch.where(uge(r_b, m_tilde >> 1), r_b + (p - m_tilde), r_b)
        qr_hi, qr_lo = mul64_wide(prod_q, r_c)
        s_lo = qr_lo + x_bsk
        s_hi = qr_hi + ult(s_lo, qr_lo).long()
        acc = barrett_reduce_128(s_hi, s_lo, p, r0, r1)
        return mul_mod(acc, inv_mt, p, r0, r1)
    if mode == "sk_tail":
        L = x.shape[-2] - 1
        p, r0, r1, prod_b = (consts[k * L:(k + 1) * L].reshape(L, 1) for k in range(4))
        m_sk, ms_r0, ms_r1, inv_b = (consts[4 * L + k] for k in range(4))
        dest, to_msk = x[..., :L, :], x[..., L, :]
        x_sk = aux[..., -1, :]
        alpha = mul_mod(to_msk + (m_sk - x_sk), inv_b, m_sk, ms_r0, ms_r1)
        alpha_b = alpha[..., None, :]
        neg = mul_mod(m_sk - alpha_b, prod_b, p, r0, r1)
        pos = mul_mod(alpha_b, p - prod_b, p, r0, r1)
        term = torch.where(ult(shr(m_sk, 1), alpha_b), neg, pos)
        return add_mod(dest, term, p)
    raise ValueError(f"unknown behz mode {mode!r}")


def behz(mode: str, x, consts, aux=None):
    """Kernel ``behz`` (csrc/behz.cu).

    sm_mrq: x [..., Bsk+1, N] (q lifted to Bsk u {m_tilde}) ->
    [..., Bsk, N].  sk_tail: x [..., L+1, N] (x_B converted onto q and
    m_sk), aux [..., Bsk, N] (x_bsk, its last row x_sk) -> [..., L, N].
    consts: the packed int64 constants of DeviceRNSTool.
    """
    tensors = [t for t in (x, consts, aux) if t is not None]
    if not is_cuda(*tensors):
        return behz_plain(mode, x, consts, aux)
    if mode not in BEHZ_MODES:
        raise ValueError(f"unknown behz mode {mode!r}")
    if x.dim() < 2 or x.shape[-2] < 2:
        raise ValueError("behz: x must be [..., rows, N] with at least two rows")
    I, N = x.shape[-2:]
    R = x.numel() // (I * N)
    A = 0
    if mode == "sk_tail":
        if aux is None or aux.shape[:-2] != x.shape[:-2] or aux.shape[-1] != N:
            raise ValueError("behz sk_tail: aux must be [..., Bsk, N] beside x")
        A = aux.shape[-2]
        need = 4 * (I - 1) + 4
    else:
        need = 5 * (I - 1) + 1
    if consts.numel() != need:
        raise ValueError(f"behz {mode}: {consts.numel()} constants, expected {need}")
    for t, what in ((x, "x"), (aux, "aux"), (consts, "consts")):
        if t is not None:
            cuda.check(t, f"behz {what}")
    out = torch.empty(x.shape[:-2] + (I - 1, N), dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    geo = rns_geometry(R, I - 1, N, _vec(N, *[t for t in (out, x, aux) if t is not None]))
    cuda.call("behz", cuda.ptr(out), cuda.ptr(x), cuda.ptr(aux), cuda.ptr(consts),
              R, I, A, N, BEHZ_MODES[mode], geo["vec"], geo["threads"], geo["grid_y"],
              geo["grid_z"], geo["shoup"])
    return out


# --------------------------------------------------------------------------
# kernel `scale_round`: BFV plaintext scaling and the {t, gamma} tail
# --------------------------------------------------------------------------

SCALE_ROUND_MODES = {"plain_add": 0, "plain_sub": 1, "t_gamma": 2}


def scale_round_plain(mode, x, consts, plain=None):
    """Plain version of :func:`scale_round`: the JAX function's steps on
    the packed constants (layout in csrc/scale_round.cu)."""
    if mode in ("plain_add", "plain_sub"):
        L = x.shape[-2]
        p, r0, r1, delta = (consts[k * L:(k + 1) * L].reshape(L, 1) for k in range(4))
        t, t_r0, t_r1, q_mod_t, thresh = (consts[4 * L + k] for k in range(5))
        m = plain
        prod_hi, prod_lo = mul64_wide(m, q_mod_t)
        num_lo = prod_lo + thresh
        num_hi = prod_hi + ult(num_lo, prod_lo).long()
        fix, _ = divmod_128(num_hi, num_lo, t, t_r0, t_r1)
        dm_hi, dm_lo = mul64_wide(delta, m)
        s_lo = dm_lo + fix
        s_hi = dm_hi + ult(s_lo, dm_lo).long()
        inc = barrett_reduce_128(s_hi, s_lo, p, r0, r1)
        return add_mod(x, inc, p) if mode == "plain_add" else sub_mod(x, inc, p)
    if mode == "t_gamma":
        t, t_r0, t_r1, g, g_r0, g_r1, neg_t, neg_g, inv_g = (consts[k] for k in range(9))
        t_part = mul_mod(x[..., 0, :], neg_t, t, t_r0, t_r1)
        g_part = mul_mod(x[..., 1, :], neg_g, g, g_r0, g_r1)
        corr_pos = barrett_reduce_64(g - g_part, t, t_r1)
        corr_neg = barrett_reduce_64(g_part, t, t_r1)
        dest = torch.where(ult(shr(g, 1), g_part), add_mod(t_part, corr_pos, t),
                           sub_mod(t_part, corr_neg, t))
        return mul_mod(dest, inv_g, t, t_r0, t_r1)
    raise ValueError(f"unknown scale_round mode {mode!r}")


def scale_round(mode: str, x, consts, plain=None):
    """Kernel ``scale_round`` (csrc/scale_round.cu).

    plain_add / plain_sub: x = c0 [..., L, N], plain = m [N] (mod t,
    zero-padded) -> c0 +- round(q/t * m), [..., L, N].  t_gamma: x [..., 2,
    N] (the q -> {t, gamma} conversion) -> round(t/q * x) mod t, [..., N].
    consts: the packed int64 constants (plain_scaling_constants,
    DeviceRNSTool.t_gamma_consts).
    """
    tensors = [t for t in (x, consts, plain) if t is not None]
    if not is_cuda(*tensors):
        return scale_round_plain(mode, x, consts, plain)
    if mode not in SCALE_ROUND_MODES:
        raise ValueError(f"unknown scale_round mode {mode!r}")
    if x.dim() < 2:
        raise ValueError("scale_round: x must be [..., rows, N]")
    L, N = x.shape[-2:]
    if mode == "t_gamma":
        if L != 2 or consts.numel() != 9:
            raise ValueError("scale_round t_gamma: x must be [..., 2, N] with 9 constants")
        out = torch.empty(x.shape[:-2] + (N,), dtype=torch.int64, device=x.device)
    else:
        if plain is None or plain.shape != (N,):
            raise ValueError(f"scale_round {mode}: plain must be [{N}]")
        if consts.numel() != 4 * L + 5:
            raise ValueError(f"scale_round {mode}: {consts.numel()} constants for {L} limbs")
        out = torch.empty_like(x)
    for t, what in ((x, "x"), (plain, "plain"), (consts, "consts")):
        if t is not None:
            cuda.check(t, f"scale_round {what}")
    if out.numel() == 0:
        return out
    R = x.numel() // (L * N)
    vec = _vec(N, *[t for t in (out, x, plain) if t is not None])
    if mode == "t_gamma":
        geo = rns_geometry(R, 1, N, vec)
    else:
        geo = rns_geometry(R, L, N, vec, share_rows=True)
    cuda.call("scale_round", cuda.ptr(out), cuda.ptr(x), cuda.ptr(plain), cuda.ptr(consts),
              R, L, N, SCALE_ROUND_MODES[mode], geo["vec"], geo["threads"], geo["grid_y"],
              geo["grid_z"])
    return out


# --------------------------------------------------------------------------
# the per-level tool
# --------------------------------------------------------------------------

def _pack(parts, device) -> torch.Tensor:
    """Flat int64 constant array from ints and u64 sequences, in order."""
    flat = []
    for v in parts:
        flat.extend(int(x) for x in (v if np.ndim(v) else [v]))
    return to_tensor(np.array(flat, dtype=np.uint64), device)


class DeviceRNSTool:
    """Device constants of one level's host RNSTool (reference:
    rns.h:186-366), on the context's device: the q limbs and the
    rescale-by-q_last constants (rns.cpp:719-729) and, for BFV only, the
    BEHZ converters, packed kernel constants and Bsk NTT tables, and the
    {t, gamma} decrypt constants.  Everything else of the RNSTool is on
    ``host``."""

    def __init__(self, host: RNSTool, device):
        self.host = host
        q = host.base_q
        moduli = q.values()
        L = q.size
        self.q_limbs = LimbConstants.from_moduli(moduli, device)
        if L >= 2:
            half = moduli[-1] >> 1
            self.inv_q_last_mod_q = _col(host.inv_q_last_mod_q, device)
            self.half_last = _col([half], device)
            self.half_mod_qi = _col([half % qi for qi in moduli[:-1]], device)
            self.zero_rest = _col([0] * (L - 1), device)
            self.ones_rest = to_tensor(np.ones((L - 1, 1), dtype=np.uint64), device)

        if host.base_t_gamma is None:
            return  # no plain modulus (CKKS): the BEHZ and decrypt parts are BFV's

        # BEHZ (rns.cpp:853-1068)
        bsk = host.base_Bsk.base
        self.Bsk_limbs = LimbConstants.from_moduli(bsk, device)
        log_n = host.coeff_count.bit_length() - 1
        self.base_Bsk_ntt_tables = build_ntt_tables(log_n, bsk).to(device)
        self.q_to_Bsk = DeviceBaseConverter.from_host(host.base_q_to_Bsk_conv, device)
        self.inv_prod_q_mod_Bsk = _col(host.inv_prod_q_mod_Bsk, device)
        # fastbconv_m_tilde as one launch: q -> Bsk u {m_tilde}, the m_tilde
        # premultiply folded into the pre-scale
        self.m_tilde_conv = DeviceBaseConverter.from_host(
            [host.base_q_to_Bsk_conv, host.base_q_to_m_tilde_conv], device,
            multiplier=[host.m_tilde.value] * L)
        # fastbconv_sk's two conversions as one launch: B -> q u {m_sk}, read
        # from the whole Bsk tensor (its x_sk row at weight 0)
        self.sk_conv = DeviceBaseConverter.from_host(
            [host.base_B_to_q_conv, host.base_B_to_m_sk_conv], device, ibase=host.base_Bsk)
        self.sm_mrq_consts = _pack(
            [[m.value for m in bsk], [m.const_ratio[0] for m in bsk],
             [m.const_ratio[1] for m in bsk], host.prod_q_mod_Bsk,
             host.inv_m_tilde_mod_Bsk, host.inv_prod_q_mod_m_tilde], device)
        self.sk_tail_consts = _pack(
            [moduli, [m.const_ratio[0] for m in q.base], [m.const_ratio[1] for m in q.base],
             host.prod_B_mod_q, host.m_sk.value, host.m_sk.const_ratio[0],
             host.m_sk.const_ratio[1], host.inv_prod_B_mod_m_sk], device)
        check_shoup_operands("sm_mrq", self.sm_mrq_consts)
        check_shoup_operands("sk_tail", self.sk_tail_consts)

        # decrypt_scale_and_round's conversion with |gamma t|_qi folded in
        self.t_gamma_conv = DeviceBaseConverter.from_host(
            host.base_q_to_t_gamma_conv, device, multiplier=host.prod_t_gamma_mod_q)
        t, g = host.t, host.gamma
        self.t_gamma_consts = _pack(
            [t.value, t.const_ratio[0], t.const_ratio[1], g.value, g.const_ratio[0],
             g.const_ratio[1], host.neg_inv_q_mod_t_gamma, host.inv_gamma_mod_t], device)
        check_shoup_operands("t_gamma", self.t_gamma_consts)


# --------------------------------------------------------------------------
# BEHZ multiply steps
# --------------------------------------------------------------------------

def fastbconv_m_tilde(x, tool: DeviceRNSTool):
    """q -> Bsk u {m_tilde} with the m_tilde premultiplication
    (reference: rns.cpp:1025-1068), one ``contract`` launch.
    [..., L, N] -> [..., Bsk+1, N]."""
    return fast_convert_array(x, tool.m_tilde_conv)


def sm_mrq(x, tool: DeviceRNSTool):
    """Montgomery reduction Bsk u {m_tilde} -> Bsk (reference:
    rns.cpp:925-981), one ``behz`` launch.  [..., Bsk+1, N] -> [..., Bsk, N]."""
    return behz("sm_mrq", x, tool.sm_mrq_consts)


def fast_floor(x_q, x_bsk, tool: DeviceRNSTool):
    """floor(x / q): input in q u Bsk -> output in Bsk (reference:
    rns.cpp:983-1023): the q -> Bsk conversion (``contract``), then
    (x_bsk - conv) * q^-1 mod Bsk (``elementwise`` submul)."""
    conv = fast_convert_array(x_q, tool.q_to_Bsk)
    bsk = tool.Bsk_limbs
    return rns_elementwise("submul", x_bsk.contiguous(), bsk.p, bsk.ratio0, bsk.ratio1,
                           b=conv, s=tool.inv_prod_q_mod_Bsk)


def fastbconv_sk(x_bsk, tool: DeviceRNSTool):
    """Shenoy-Kumaresan Bsk -> q (reference: rns.cpp:853-923): B -> q and
    B -> m_sk as one ``contract`` launch, then the alpha correction
    (``behz`` sk_tail).  [..., Bsk, N] -> [..., L, N]."""
    x_bsk = x_bsk.contiguous()
    conv = fast_convert_array(x_bsk, tool.sk_conv)
    return behz("sk_tail", conv, tool.sk_tail_consts, aux=x_bsk)


# --------------------------------------------------------------------------
# BFV decrypt, encrypt and modulus switching
# --------------------------------------------------------------------------

def decrypt_scale_and_round(x, tool: DeviceRNSTool):
    """BFV decrypt tail: round(t/q * x) mod t via the {t, gamma} trick
    (reference: rns.cpp:1070-1126): one ``contract`` launch (|gamma t|_q
    folded into its pre-scale), then ``scale_round`` t_gamma.
    x: [..., L, N] -> [..., N] mod t."""
    tg = fast_convert_array(x.contiguous(), tool.t_gamma_conv)
    return scale_round("t_gamma", tg, tool.t_gamma_consts)


@span("rns.rescale")
def divide_and_round_q_last(x, tool: DeviceRNSTool):
    """Drop the last limb with rounding, power basis: [..., L, N] ->
    [..., L-1, N] (reference: rns.cpp:731-775).

    The last limb plus q_last/2 (``elementwise`` barrett64), lifted into
    every remaining limb by a ``contract`` launch with unit weights (its
    Barrett is the same canonical reduction as the JAX barrett_reduce_64),
    minus q_last/2 mod q_i (``elementwise`` sub), then (rest - temp) *
    q_last^-1 (``elementwise`` submul: equal to sub_mod then mul_mod for
    canonical residues)."""
    L = x.shape[-2]
    q = tool.q_limbs
    last_l, rest_l = q.slice(L - 1, L), q.slice(0, L - 1)
    last = rns_elementwise("barrett64", x[..., L - 1 : L, :].contiguous(), last_l.p,
                           last_l.ratio0, last_l.ratio1, b=tool.half_last)
    lifted = _dot_mod_128(last, tool.ones_rest, rest_l)
    temp = rns_elementwise("sub", lifted, rest_l.p, rest_l.ratio0, rest_l.ratio1,
                           b=tool.half_mod_qi)
    return rns_elementwise("submul", x[..., : L - 1, :].contiguous(), rest_l.p,
                           rest_l.ratio0, rest_l.ratio1, b=temp, s=tool.inv_q_last_mod_q)


@span("rns.rescale")
def divide_and_round_q_last_ntt(x, tool: DeviceRNSTool, tables: NTTTables, ntt=None):
    """Drop the last limb with rounding, NTT-domain input and output
    (reference: rns.cpp:777-851): iNTT the last limb, add q_last/2 and
    reduce, lift it into each remaining limb, subtract q_last/2 there,
    forward-NTT, subtract from the rest and multiply by q_last^{-1}.
    [..., L, N] -> [..., L-1, N].

    `ntt` optionally swaps the transform entry points (keyswitch.NTTOps):
    the coefficient-sharded pipeline passes the four-step bodies."""
    fwd = ntt_forward if ntt is None else ntt.forward
    inv = ntt_inverse if ntt is None else ntt.inverse
    L = x.shape[-2]
    q = tool.q_limbs
    last_l, rest_l = q.slice(L - 1, L), q.slice(0, L - 1)
    rest = x[..., : L - 1, :].contiguous()
    last = inv(x[..., L - 1 : L, :].contiguous(), _slice_tables(tables, L - 1, L))
    last = rns_elementwise("barrett64", last, last_l.p, last_l.ratio0, last_l.ratio1,
                           b=tool.half_last)
    lifted = last.expand(last.shape[:-2] + (L - 1, last.shape[-1])).contiguous()
    lifted = rns_elementwise("barrett64", lifted, rest_l.p, rest_l.ratio0,
                             rest_l.ratio1, b=tool.zero_rest)
    temp = rns_elementwise("sub", lifted, rest_l.p, rest_l.ratio0, rest_l.ratio1,
                           b=tool.half_mod_qi)
    temp = fwd(temp, _slice_tables(tables, 0, L - 1))
    diff = rns_elementwise("sub", rest, rest_l.p, rest_l.ratio0, rest_l.ratio1, b=temp)
    return rns_elementwise("mul", diff, rest_l.p, rest_l.ratio0, rest_l.ratio1,
                           b=tool.inv_q_last_mod_q)


class MultiDropPlan:
    """Constants for the fused multi-level BFV mod-switch: one rounded
    division by Q_D = prod(dropped primes) instead of a per-level chain of
    divide_and_round_q_last calls (no reference analogue; the sequential
    chain is evaluator.cpp mod_switch_to_inplace).  The approximate CRT
    interpolation adds at most |D| to the quotient: bounded sub-noise, so
    results decrypt identically."""

    def __init__(self, context, parms_id, levels: int):
        cd = context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for the context")
        dev = context.device
        moduli = [m.value for m in cd.parms.coeff_modulus]
        L = len(moduli)
        if not 1 <= levels < L:
            raise ValueError("levels must drop at least one and keep one prime")
        self.levels = levels
        d_moduli = moduli[L - levels:]
        out_moduli = moduli[: L - levels]
        q_d, inv_hat, hat_qi, inv_qd = crt_drop_constants(d_moduli, out_moduli)
        half = q_d >> 1

        self.d_limbs = LimbConstants.from_moduli(d_moduli, dev)
        self.out_limbs = LimbConstants.from_moduli(out_moduli, dev)
        self.inv_hat_d = _col(inv_hat, dev)
        self.half_d = _col([half % d for d in d_moduli], dev)
        self.hat_d_qi = to_tensor(hat_qi, dev)
        self.inv_qd_qi = _col(inv_qd, dev)
        self.half_qi = _col([half % q for q in out_moduli], dev)
        self.n_out = len(out_moduli)


def divide_and_round_multi(x, plan: MultiDropPlan):
    """Fused rounded division by Q_D (power-basis input):
    y_i = (x_i - [(x + Q_D/2) mod Q_D] + Q_D/2) * Q_D^{-1} mod q_i,
    with the bracket CRT-interpolated from the dropped limbs: (x_d +
    Q_D/2) * (Q_D/d)^-1 (``elementwise`` addmul), the interpolation onto
    the kept limbs (``contract``), minus Q_D/2 (``elementwise`` sub), then
    (x_i - temp) * Q_D^-1 (``elementwise`` submul).
    [..., L, N] -> [..., L - levels, N]."""
    no = plan.n_out
    dl, ol = plan.d_limbs, plan.out_limbs
    scaled = rns_elementwise("addmul", x[..., no:, :].contiguous(), dl.p, dl.ratio0,
                             dl.ratio1, b=plan.half_d, s=plan.inv_hat_d)
    interp = _dot_mod_128(scaled, plan.hat_d_qi, ol)
    temp = rns_elementwise("sub", interp, ol.p, ol.ratio0, ol.ratio1, b=plan.half_qi)
    return rns_elementwise("submul", x[..., :no, :].contiguous(), ol.p, ol.ratio0,
                           ol.ratio1, b=temp, s=plan.inv_qd_qi)


def plain_scaling_constants(context_data) -> torch.Tensor:
    """Packed constants of the plain_add/plain_sub modes for one level
    (layout in csrc/scale_round.cu): the level's q limbs, Delta = floor(q/t)
    mod q_i, t with its Barrett ratios, q mod t and ceil(t/2)."""
    mods = context_data.parms.coeff_modulus
    t = context_data.parms.plain_modulus
    return _pack(
        [[m.value for m in mods], [m.const_ratio[0] for m in mods],
         [m.const_ratio[1] for m in mods], context_data.coeff_div_plain_modulus,
         t.value, t.const_ratio[0], t.const_ratio[1],
         context_data.coeff_modulus_mod_plain_modulus,
         context_data.plain_upper_half_threshold], context_data.device)


def multiply_add_plain_with_scaling_variant(c0, plain, context_data):
    """c0 += round(q/t * m): Delta*m plus the exact rounding fix
    (reference: scalingvariant.cpp:15-52), one ``scale_round`` launch.

    c0: [..., L, N]; plain: int64[N] mod t (zero-padded) on c0's device."""
    return scale_round("plain_add", c0.contiguous(), context_data.plain_scaling_constants,
                       plain=plain)


def multiply_sub_plain_with_scaling_variant(c0, plain, context_data):
    """c0 -= round(q/t * m) (reference: scalingvariant.cpp:54-92)."""
    return scale_round("plain_sub", c0.contiguous(), context_data.plain_scaling_constants,
                       plain=plain)
