"""CKKS bootstrapping: refresh an exhausted ciphertext without decrypting.

Port of gemini_seal_tpu/models/bootstrap.py (the HEAAN-style bootstrap of
Cheon, Han, Kim, Kim and Song):

    ct at the last level (mod q0 only)
      | mod_raise     inverse NTT at q0 (``ntt``), centred lift re-reduced
      |               against every top-level prime (``mod_raise``), forward
      |               NTT (``ntt``): the plaintext becomes m + q0 I, |I| <~ K
      | CoeffToSlot   hoisted-rotation matvecs (build_ckks_matvec or
      |               build_ckks_matvec_bsgs) put the scaled coefficient
      |               halves into slots
      | EvalMod       "cosine": the Chebyshev-cosine engine (models/evalmod.py);
      |               "exp": a degree-7 Taylor of exp and r squarings
      | SlotToCoeff   matvecs fold q0/(2 pi) back into the coefficients
      v
    a ciphertext near the top of the chain, same message, same scale

linear_mode "dense" runs the numerically derived slot matrices as BSGS
matvecs (2 levels per transform); "split" runs the radix-2 butterfly
stages of the slot transform collapsed into ceil(log2(s)/radix) sparse
groups, one level each.  Every host constant (the stage diagonals, their
products, the Chebyshev fit, the folded scale constants) is the JAX
package's float64 arithmetic in the same order, so every encoded plaintext,
and with it the refreshed ciphertext, is bit-identical to the JAX
package's.  Conjugation is one ``galois`` launch at element 2N-1 and a key
switch; the rescale is divide_and_round_q_last_ntt; the plaintext products
and sums are ``elementwise`` launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..context import SealContext
from ..ops.backend import to_tensor
from ..ops.dyadic import add_poly, dyadic_product, sub_poly
from ..ops.keyswitch import KeySwitchPlan, switch_key
from ..ops.modraise import mod_raise_lift
from ..ops.ntt import ntt_forward, ntt_inverse
from ..ops.rnsops import divide_and_round_q_last_ntt
from .pipelines import build_ckks_matvec, build_ckks_matvec_bsgs, build_ckks_mul_relin_rescale

__all__ = ["plan_bootstrap_chain", "derive_slot_matrices", "special_fft_stage_diagonals",
           "compose_diagonals", "ModRaisePlan", "mod_raise", "build_ckks_bootstrap"]


def plan_bootstrap_chain(n: int, radix: int = 3, K: int = None, r: int = None,
                         scale_bits: int = 45, em_bits: int = 59, restored: int = 1,
                         nsp: int = 3):
    """Modulus-chain layout for a split-cosine refresh: the bootstrap's
    levels get `em_bits`-wide primes, the `restored` levels after the
    refresh keep `scale_bits` primes.  Returns (bits, n_levels, K): pass
    bits to CoeffModulus.create and encrypt at scale 2**scale_bits."""
    from .evalmod import plan_evalmod

    if K is None:
        K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
    _, _, em_depth = plan_evalmod(K, r)
    gn = (int(math.log2(n // 2)) + radix - 1) // radix
    n_levels = 2 * gn + em_depth + 1
    bits = [59] + [scale_bits] * restored + [em_bits] * n_levels + [59] * nsp
    return bits, n_levels, K


def derive_slot_matrices(encoder):
    """(E, Minv): E[j, k] = slot j of the unit coefficient k (the decode map
    in the generator-5 slot order); Minv inverts [E; conj(E)]."""
    n = encoder._n
    s = encoder.slots
    F = encoder._embedding_forward(np.eye(n, dtype=np.complex128))
    E = F[:, encoder._index_map[:s]].T                       # [s, n]
    Minv = np.linalg.inv(np.vstack([E, np.conj(E)]))         # [n, n]
    return E, Minv


def _matrix_diagonals(M):
    """Square matrix -> generalized diagonals {d: [M[i, (i+d) % s] for i]}."""
    s = M.shape[0]
    idx = (np.arange(s)[:, None] + np.arange(s)[None, :]) % s
    cols = M[np.arange(s)[:, None], idx]                     # [s(i), s(d)]
    return {d: cols[:, d] for d in range(s)}


def special_fft_stage_diagonals(encoder):
    """The s-point slot transform as radix-2 butterfly stages in diagonal
    form: E1 = B_m ... B_1 P (P the bit reversal, omitted: it cancels
    between CoeffToSlot and SlotToCoeff), each B_t with the diagonals
    {0, +2^(t-1), s - 2^(t-1)}.  Returns (fwd, inv): per-stage
    {offset: complex[s]} of B_t and B_t^-1, t = 1..log2(s)."""
    s = encoder.slots
    M = 4 * s
    psi = np.exp(2j * np.pi / M)
    rot = [pow(5, j, M) for j in range(s)]
    fwd, inv = [], []
    ln = 2
    while ln <= s:
        lenh, lenq = ln // 2, ln * 4
        d0f = np.zeros(s, complex)
        dpf = np.zeros(s, complex)
        dmf = np.zeros(s, complex)
        d0i = np.zeros(s, complex)
        dpi = np.zeros(s, complex)
        dmi = np.zeros(s, complex)
        for i in range(0, s, ln):
            for j in range(lenh):
                w = psi ** ((rot[j] % lenq) * (M // lenq))
                u, l = i + j, i + j + lenh
                d0f[u] = 1.0
                dpf[u] = w                    # B[u, u + lenh]
                d0f[l] = -w
                dmf[l] = 1.0                  # B[l, l - lenh]
                d0i[u] = 0.5
                dpi[u] = 0.5
                d0i[l] = -0.5 / w
                dmi[l] = 0.5 / w

        # at the last stage +lenh and s-lenh are the same cyclic offset
        def _merged(d0, dp, dm):
            out = {0: d0}
            for d, v in ((lenh, dp), ((s - lenh) % s, dm)):
                out[d] = v if d not in out else out[d] + v
            return out

        fwd.append(_merged(d0f, dpf, dmf))
        inv.append(_merged(d0i, dpi, dmi))
        ln *= 2
    return fwd, inv


def compose_diagonals(A, B, s):
    """Diagonals of A @ B: (A @ B)_{dA+dB}[i] += A_dA[i] * B_dB[(i + dA) % s];
    exact-zero diagonals dropped."""
    out = {}
    for dA, va in A.items():
        for dB, vb in B.items():
            d = (dA + dB) % s
            term = va * np.roll(vb, -dA)
            out[d] = term if d not in out else out[d] + term
    return {d: v for d, v in out.items() if np.abs(v).max() > 1e-14}


def _collapse_chain(stages_in_application_order, s, radix):
    """Consecutive stages grouped radix at a time: group = last @ ... @ first."""
    groups = []
    for i in range(0, len(stages_in_application_order), radix):
        chunk = stages_in_application_order[i:i + radix]
        G = chunk[0]
        for B in chunk[1:]:
            G = compose_diagonals(B, G, s)
        groups.append(G)
    return groups


def _scale_diagonals(D, c):
    return {d: c * v for d, v in D.items()}


class ModRaisePlan:
    """Constants of mod_raise: the centred lift from the last level's lone
    prime q0 to the full top-level basis, on the context's device."""

    def __init__(self, context: SealContext, last_parms_id, top_parms_id):
        last_cd = context.get_context_data(last_parms_id)
        top_cd = context.get_context_data(top_parms_id)
        if len(last_cd.parms.coeff_modulus) != 1:
            raise ValueError("mod_raise expects a last-level (L=1) input")
        self.q0 = last_cd.parms.coeff_modulus[0].value
        if top_cd.parms.coeff_modulus[0].value != self.q0:
            raise ValueError("chain must keep q0 as its base prime")
        self.last_tables = last_cd.ntt_tables
        self.top_tables = top_cd.ntt_tables
        mods = top_cd.parms.coeff_modulus
        dev = context.device
        self.p = to_tensor([m.value for m in mods], dev)
        self.ratio1 = to_tensor([m.const_ratio[1] for m in mods], dev)
        self.q0_mod_p = to_tensor([self.q0 % m.value for m in mods], dev)
        self.half = self.q0 >> 1


def mod_raise(ct_data, plan: ModRaisePlan):
    """int64[..., 2, 1, N] mod q0 (NTT form) -> int64[..., 2, L_top, N] (NTT
    form): inverse NTT, the centred lift of each residue to (-q0/2, q0/2]
    reduced against every top-level prime, forward NTT.  The plaintext
    becomes m + q0*I."""
    c = ntt_inverse(ct_data.contiguous(), plan.last_tables)        # [..., 2, 1, N]
    out = mod_raise_lift(c, plan.p, plan.ratio1, plan.q0_mod_p, plan.half)
    return ntt_forward(out, plan.top_tables)


def _top(x, L):
    return x[..., :L, :].contiguous()


def build_ckks_bootstrap(context: SealContext, scale: float, encoder, msg_bound: float = 1.0,
                         K: int = None, r: int = None, baby: int = None,
                         composed: bool = True, linear_mode: str = "dense", radix: int = 3,
                         evalmod: str = "cosine", f_bits: int = None, device=None):
    """fn(ct_data, rot_keys_stack, conj_key, relin_key) -> refreshed ct.

    ct_data: int64[..., 2, 1, N] at the last level of the chain (NTT form)
    with the given `scale`; the output encrypts the same slot values at the
    same scale (to float rounding) at `out_parms_id`.  rot_keys_stack:
    int64[len(rot_steps), n_bundles, 2, L_key, N] stacked for `rot_steps`;
    conj_key: the key of element 2N-1; relin_key: the relinearization key.
    All on the context's device (None means the card).

    Returns (fn, out_parms_id, out_scale, rot_steps, conj_elt), and fn's
    output is bit-identical to the JAX package's for the same options.
    linear_mode "dense" or "split", evalmod "cosine" or "exp", K, r, baby,
    radix and f_bits as in the JAX package.  composed is accepted for the
    JAX signature (there it jits one program per stage, a TPU compile
    workaround); both values return the same eager chain.
    """
    from .evalmod import ChebyEvalMod, plan_evalmod

    context.check_device(device)
    n = encoder._n
    s = encoder.slots
    if K is None:
        K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
    if evalmod not in ("cosine", "exp"):
        raise ValueError(f"unknown evalmod {evalmod!r}")
    if evalmod == "cosine":
        r, cos_coeffs, em_depth = plan_evalmod(K, r)
    else:
        if r is None:
            r = int(math.ceil(math.log2(2 * math.pi * (K + 1.5) / 0.15)))
        em_depth = 4 + r
    if linear_mode not in ("dense", "split"):
        raise ValueError(f"unknown linear_mode {linear_mode!r}")
    if linear_mode == "split":
        m_st = int(math.log2(s))
        if 2 ** m_st != s or s < 2:
            raise ValueError("split mode needs a power-of-two slot count")
        Gn = (m_st + radix - 1) // radix
        base = Gn
        # cosine split spends one shared normalization level: the halves
        # are extracted at 2^F headroom, then one plain multiply + rescale
        # returns to the EvalMod scale
        norm_extra = 1 if evalmod == "cosine" else 0
        n_levels = 2 * Gn + em_depth + norm_extra
    else:
        base = 2
        norm_extra = 0
        n_levels = 4 + em_depth

    # ---- the chain from the top: the levels each stage uses ----------------
    cds = [context.get_context_data(context.first_parms_id)]
    for _ in range(n_levels):
        nxt = cds[-1].next_context_data
        if nxt is None:
            raise ValueError(f"modulus chain too short: bootstrap needs {n_levels} levels "
                             f"below the top (r={r} squarings, linear_mode={linear_mode!r})")
        cds.append(nxt)
    last_cd = cds[-1]
    while last_cd.next_context_data is not None:
        last_cd = last_cd.next_context_data
    top_cd = cds[0]
    q = [cd.parms.coeff_modulus[-1].value for cd in cds]      # q[i] dropped i -> i+1
    limbs = [cd.limb_constants for cd in cds]
    L = [len(cd.parms.coeff_modulus) for cd in cds]
    q0 = last_cd.parms.coeff_modulus[0].value

    raise_plan = ModRaisePlan(context, last_cd.parms_id, top_cd.parms_id)
    Dl = float(scale)
    gamma = 2j * math.pi * Dl / (float(q0) * float(2 ** r))
    if f_bits is None:
        f_bits = (12 + max(0, (n // 2).bit_length() - 7) + max(0, (K + 1).bit_length() - 4))
    F_bits = min(int(f_bits), 30)
    lvl_s2c = base + em_depth + norm_extra

    # ---- primitives -----------------------------------------------------------
    conj_elt = 2 * n - 1
    if evalmod == "cosine":
        conj_levels = (0,) if linear_mode == "dense" else (base,)
    else:
        conj_levels = (0, lvl_s2c) if linear_mode == "dense" else (base, lvl_s2c)
    conj_plans = {lvl: KeySwitchPlan(context, cds[lvl].parms_id) for lvl in conj_levels}
    galois_tools = {lvl: cds[lvl].galois_tool for lvl in conj_levels}
    for lvl in conj_levels:
        galois_tools[lvl].ntt_tables([conj_elt])      # upload the table at build time

    def conjugate(ct, lvl, conj_key):
        rot = galois_tools[lvl].apply_galois_ntt(ct, conj_elt)     # both components
        d0, d1 = switch_key(rot[..., 1, :, :], conj_key, conj_plans[lvl], True)
        return torch.stack([add_poly(rot[..., 0, :, :].contiguous(), d0, limbs[lvl]), d1],
                           dim=-3)

    def rescale(ct, lvl):
        """One q-last division at level lvl -> level lvl + 1."""
        cd = cds[lvl]
        return divide_and_round_q_last_ntt(ct.contiguous(), cd.device_rns_tool, cd.ntt_tables)

    def plain_mul(ct, pt, lvl):
        return dyadic_product(ct.contiguous(), pt, limbs[lvl])

    def plain_add(ct, pt, lvl):
        c0 = add_poly(ct[..., 0, :, :].contiguous(), pt, limbs[lvl])
        return torch.cat([c0.unsqueeze(-3), ct[..., 1:, :, :]], dim=-3)

    def ct_add(x, y, lvl):
        return add_poly(x.contiguous(), y.contiguous(), limbs[lvl])

    def ct_sub(x, y, lvl):
        return sub_poly(x.contiguous(), y.contiguous(), limbs[lvl])

    def _enc(val, sc, lvl):
        if isinstance(val, complex):
            return encoder.encode([val] * s, sc, cds[lvl].parms_id).data
        return encoder.encode(val, sc, cds[lvl].parms_id).data

    def mul_step(lvl, square=False):
        return build_ckks_mul_relin_rescale(context, cds[lvl].parms_id, square=square,
                                            device=device)

    # Taylor coefficients of exp: a_k = 1/k!
    a = [1.0 / math.factorial(k) for k in range(8)]

    def make_evalmod(b, sigma_u, c=1.0):
        """Degree-7 Taylor of exp(c x) and r double-angle squarings from
        level b at input scale sigma_u.  Returns (stage_fn, sigma_z)."""
        sq_b, sq_b1 = mul_step(b, True), mul_step(b + 1, True)
        mul3, mul_hi = mul_step(b + 1), mul_step(b + 2)
        sigma_u2 = sigma_u * sigma_u / float(q[b])            # level b+1
        sigma_u3 = sigma_u2 * sigma_u / float(q[b + 1])       # level b+2
        sigma_u4 = sigma_u2 * sigma_u2 / float(q[b + 1])      # level b+2
        sigma_hi = Dl * Dl
        sigma_w = sigma_u4 * sigma_hi / float(q[b + 2])       # level b+3
        ck = [c ** k for k in range(8)]
        # hi = a4 + a5 u + a6 u2 + a7 u3, aligned at level b+2, scale hi
        hi_u = _enc(a[5] * ck[5], sigma_hi / sigma_u, b + 2)
        hi_u2 = _enc(a[6] * ck[6], sigma_hi / sigma_u2, b + 2)
        hi_u3 = _enc(a[7] * ck[7], sigma_hi / sigma_u3, b + 2)
        hi_c = _enc(a[4] * ck[4], sigma_hi, b + 2)
        # low = a0 + a1 u + a2 u2 + a3 u3, aligned at level b+3
        lo_u = _enc(a[1] * ck[1], sigma_w / sigma_u, b + 3)
        lo_u2 = _enc(a[2] * ck[2], sigma_w / sigma_u2, b + 3)
        lo_u3 = _enc(a[3] * ck[3], sigma_w / sigma_u3, b + 3)
        lo_c = _enc(a[0] * ck[0], sigma_w, b + 3)
        sigma_w6 = sigma_w / float(q[b + 3])                  # level b+4
        sq_r = [mul_step(b + 4 + i, True) for i in range(r)]
        sigma_z = sigma_w6
        for i in range(r):
            sigma_z = sigma_z * sigma_z / float(q[b + 4 + i])

        def stage(u, relin_key):
            u2 = sq_b(u, relin_key)                                   # level b+1
            u3 = mul3(u2, _top(u, L[b + 1]), relin_key)               # level b+2
            u4 = sq_b1(u2, relin_key)                                 # level b+2
            hi = plain_mul(_top(u, L[b + 2]), hi_u, b + 2)
            hi = add_poly(hi, plain_mul(_top(u2, L[b + 2]), hi_u2, b + 2), limbs[b + 2])
            hi = add_poly(hi, plain_mul(u3, hi_u3, b + 2), limbs[b + 2])
            hi = plain_add(hi, hi_c, b + 2)
            w = mul_hi(u4, hi, relin_key)                             # level b+3
            lo = plain_mul(_top(u, L[b + 3]), lo_u, b + 3)
            lo = add_poly(lo, plain_mul(_top(u2, L[b + 3]), lo_u2, b + 3), limbs[b + 3])
            lo = add_poly(lo, plain_mul(_top(u3, L[b + 3]), lo_u3, b + 3), limbs[b + 3])
            lo = plain_add(lo, lo_c, b + 3)
            w = add_poly(w, lo.contiguous(), limbs[b + 3])
            w = rescale(w, b + 3)                                     # level b+4
            for i in range(r):
                w = sq_r[i](w, relin_key)                             # level b+5+i
            return w

        return stage, sigma_z

    if linear_mode == "split":
        fwd_st, inv_st = special_fft_stage_diagonals(encoder)
        inv_app = list(reversed(inv_st))          # B_m^{-1} applied first
        c2s_groups = _collapse_chain(inv_app, s, radix)
        s2c_groups = _collapse_chain(fwd_st, s, radix)
        assert len(c2s_groups) == len(s2c_groups) == Gn

        step_set = set()
        for g in c2s_groups + s2c_groups:
            step_set |= {d for d in g if d != 0}
        rot_steps = sorted(step_set)
        sidx = {d: i for i, d in enumerate(rot_steps)}
        dev = context.device

        def make_group(diag, lvl, delta):
            fn = build_ckks_matvec(context, diag, delta, encoder, parms_id=cds[lvl].parms_id,
                                   device=device)
            st = [d for d in sorted(diag) if d != 0]
            idx = torch.tensor([sidx[d] for d in st], dtype=torch.int64, device=dev)
            return fn, idx

        # CoeffToSlot: the total front constant folded into the diagonals,
        # |c|^(1/Gn) per group (the phase on the first); the normalization
        # plaintext's rounding (gamma_n) is folded in exactly
        gamma_n = 1.0
        if evalmod == "cosine":
            sig_n = float(q[base]) / (2.0 ** F_bits)
            gamma_n = round(sig_n) / sig_n
        # the EvalMod working scale: the native width of its own levels
        Dl_em = (float(2 ** int(round(math.log2(float(q[base + 1])))))
                 if evalmod == "cosine" else Dl)
        gtot = (Dl_em * (2.0 ** F_bits) / (2.0 * float(q0) * (K + 1) * gamma_n)
                if evalmod == "cosine" else gamma / 2.0)
        gmag = abs(gtot) ** (1.0 / Gn)
        gphase = gtot / abs(gtot)
        cfac = [gphase * gmag] + [gmag] * (Gn - 1)
        c2s_fns = [make_group(_scale_diagonals(g, cfac[gi]), gi, float(q[gi]))
                   for gi, g in enumerate(c2s_groups)]

        if evalmod == "cosine":
            eng_a = ChebyEvalMod(context, cds, q, limbs, L, encoder, base + 1, Dl_em,
                                 cos_coeffs, r, imag=False, device=device)
            eng_b = ChebyEvalMod(context, cds, q, limbs, L, encoder, base + 1, Dl_em,
                                 cos_coeffs, r, imag=True, device=device)
            assert eng_a.depth == eng_b.depth == em_depth
            assert math.isclose(eng_a.sigma_z, eng_b.sigma_z, rel_tol=1e-9)
            em_a, em_b, sigma_z = eng_a.stage, eng_b.stage, eng_a.sigma_z
        else:
            # the chain output holds (gamma/2)(a + i b) with gamma imaginary:
            # t - conj(t) = gamma a (constant 1), t + conj(t) = i gamma b (-i)
            em_a, sigma_z = make_evalmod(base, Dl, 1.0)
            em_b, _ = make_evalmod(base, Dl, -1j)

        # SlotToCoeff: the first group carries kappa (and i kappa for the b
        # half) and the Dl/sigma_z realignment; later groups are neutral
        kap = (float(q0) / (2.0 * math.pi * Dl) if evalmod == "cosine"
               else complex(q0) / (4j * math.pi * Dl))
        delta1 = float(q[lvl_s2c]) * Dl / sigma_z
        s2c_a = make_group(_scale_diagonals(s2c_groups[0], kap), lvl_s2c, delta1)
        s2c_b = make_group(_scale_diagonals(s2c_groups[0], 1j * kap), lvl_s2c, delta1)
        s2c_rest = [make_group(g, lvl_s2c + gi, float(q[lvl_s2c + gi]))
                    for gi, g in enumerate(s2c_groups[1:], start=1)]
        sigma_out = (sigma_z * delta1) / float(q[lvl_s2c])
        out_cd = cds[lvl_s2c + Gn]

        def keys(rot_keys_stack, idx):
            """The group's keys gathered out of the stack (a torch copy)."""
            return rot_keys_stack.index_select(0, idx)

        if evalmod == "cosine":
            # real fold at 2^F headroom, then one shared normalization level
            pt_norm = encoder.encode(1.0, float(q[base]) / (2.0 ** F_bits),
                                     cds[base].parms_id).data

            def stage_split(t, conj_key):
                tc = conjugate(t, base, conj_key)
                xa = plain_mul(ct_add(t, tc, base), pt_norm, base)
                xb = plain_mul(ct_sub(t, tc, base), pt_norm, base)
                return rescale(xa, base), rescale(xb, base)

            def stage_s2c_first(wa, wb, conj_key, rot_keys_stack):
                (fa, ia), (fb, ib) = s2c_a, s2c_b
                y = ct_add(fa(wa, keys(rot_keys_stack, ia)), fb(wb, keys(rot_keys_stack, ib)),
                           lvl_s2c)
                return rescale(y, lvl_s2c)
        else:
            def stage_split(t, conj_key):
                tc = conjugate(t, base, conj_key)
                return ct_sub(t, tc, base), ct_add(t, tc, base)

            def stage_s2c_first(wa, wb, conj_key, rot_keys_stack):
                xa = ct_sub(wa, conjugate(wa, lvl_s2c, conj_key), lvl_s2c)
                xb = ct_sub(wb, conjugate(wb, lvl_s2c, conj_key), lvl_s2c)
                (fa, ia), (fb, ib) = s2c_a, s2c_b
                y = ct_add(fa(xa, keys(rot_keys_stack, ia)), fb(xb, keys(rot_keys_stack, ib)),
                           lvl_s2c)
                return rescale(y, lvl_s2c)

        def fn(ct_data, rot_keys_stack, conj_key, relin_key):
            t = mod_raise(ct_data, raise_plan)
            for gi, (g, idx) in enumerate(c2s_fns):
                t = rescale(g(t, keys(rot_keys_stack, idx)), gi)
            xa, xb = stage_split(t, conj_key)
            wa = em_a(xa, relin_key)
            wb = em_b(xb, relin_key)
            y = stage_s2c_first(wa, wb, conj_key, rot_keys_stack)
            for gi, (g, idx) in enumerate(s2c_rest, start=1):
                y = rescale(g(y, keys(rot_keys_stack, idx)), lvl_s2c + gi)
            return y

        return fn, out_cd.parms_id, sigma_out, rot_steps, conj_elt

    # ================= dense mode (BSGS slot matrices) ===================
    E, Minv = derive_slot_matrices(encoder)
    delta_c2s = float(q[0]) * float(q[1])
    # u_h = W_h @ [z; conj z], W_h = c * the Minv rows of half h
    gfront = (Dl / (float(q0) * (K + 1)) if evalmod == "cosine" else gamma)
    Wz = [gfront * Minv[:s, :s], gfront * Minv[s:, :s]]      # act on z
    Wc = [gfront * Minv[:s, s:], gfront * Minv[s:, s:]]      # act on conj z

    top_id = top_cd.parms_id

    def bsgs(M, delta, parms_id):
        return build_ckks_matvec_bsgs(context, _matrix_diagonals(M), delta, encoder,
                                      parms_id=parms_id, baby=baby, device=device)

    c2s = []
    rot_steps = None
    for h in range(2):
        fz, steps_z = bsgs(Wz[h], delta_c2s, top_id)
        fc, steps_c = bsgs(Wc[h], delta_c2s, top_id)
        if rot_steps is None:
            rot_steps = steps_z
        if steps_z != rot_steps or steps_c != rot_steps:
            raise AssertionError("BSGS step sets must agree across maps")
        c2s.append((fz, fc))

    sigma_u = Dl * delta_c2s / (float(q[0]) * float(q[1]))
    if evalmod == "cosine":
        engine = ChebyEvalMod(context, cds, q, limbs, L, encoder, 2, sigma_u, cos_coeffs, r,
                              imag=False, device=device)
        assert engine.depth == em_depth
        stage_evalmod, sigma_z = engine.stage, engine.sigma_z
    else:
        stage_evalmod, sigma_z = make_evalmod(2, sigma_u, 1.0)

    s2c_id = cds[lvl_s2c].parms_id
    delta_s2c = float(q[lvl_s2c]) * float(q[lvl_s2c + 1]) * Dl / sigma_z
    s2c = []
    if evalmod == "cosine":
        # w_h is already the real sin: one matvec per half
        kap = float(q0) / (2 * math.pi * Dl)
        Ch = [kap * E[:, :s], kap * E[:, s:]]
        for h in range(2):
            fz, steps_z = bsgs(Ch[h], delta_s2c, s2c_id)
            if steps_z != rot_steps:
                raise AssertionError("BSGS step sets must agree across maps")
            s2c.append((fz, None))
    else:
        kap = float(q0) / (2 * math.pi * Dl) / 2j
        Cz = [kap * E[:, :s], kap * E[:, s:]]
        Cc = [-kap * E[:, :s], -kap * E[:, s:]]
        for h in range(2):
            fz, steps_z = bsgs(Cz[h], delta_s2c, s2c_id)
            fc, steps_c = bsgs(Cc[h], delta_s2c, s2c_id)
            if steps_z != rot_steps or steps_c != rot_steps:
                raise AssertionError("BSGS step sets must agree across maps")
            s2c.append((fz, fc))
    out_cd = cds[lvl_s2c + 2]
    out_scale = sigma_z * delta_s2c / (float(q[lvl_s2c]) * float(q[lvl_s2c + 1]))

    def fn(ct_data, rot_keys_stack, conj_key, relin_key):
        z = mod_raise(ct_data, raise_plan)                                # top level
        zc = conjugate(z, 0, conj_key)
        terms = []
        for h in range(2):
            fz, fc = c2s[h]
            u = add_poly(fz(z, rot_keys_stack), fc(zc, rot_keys_stack), limbs[0])
            w = stage_evalmod(rescale(rescale(u, 0), 1), relin_key)      # from level 2
            fz, fc = s2c[h]
            if fc is None:                       # cosine: w is real already
                terms.append(fz(w, rot_keys_stack))
            else:
                wc = conjugate(w, lvl_s2c, conj_key)
                terms.append(add_poly(fz(w, rot_keys_stack), fc(wc, rot_keys_stack),
                                      limbs[lvl_s2c]))
        out = add_poly(terms[0], terms[1], limbs[lvl_s2c])
        return rescale(rescale(out, lvl_s2c), lvl_s2c + 1)

    return fn, out_cd.parms_id, out_scale, rot_steps, conj_elt
