"""RNS operations of the CKKS path.

Port of the parts of gemini_seal_tpu/ops/rnsops.py that the CKKS
multiply + relinearize + rescale path and CKKS encryption need:
``_dot_mod_128`` (the base-conversion contraction, one launch of the
``contract`` kernel), ``_slice_tables``, ``crt_drop_constants`` and
``divide_and_round_q_last_ntt`` (the mod-switch of a fresh encryption from
the key level, composed of the ``ntt`` and ``elementwise`` kernels).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..utils import numth
from .backend import to_tensor
from .dyadic import LimbConstants
from .modops import contract_mulmod_128, rns_elementwise
from .ntt import NTTTables, ntt_forward, ntt_inverse

__all__ = ["DeviceRNSTool", "divide_and_round_q_last_ntt", "crt_drop_constants"]


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


class DeviceRNSTool:
    """Device constants of one level's RNSTool that the CKKS path uses:
    the q limbs and the rescale-by-q_last constants (rns.cpp:719-729)."""

    def __init__(self, moduli, device):
        moduli = [int(m) for m in moduli]
        self.q_limbs = LimbConstants.from_moduli(moduli, device)
        L = len(moduli)
        if L < 2:
            self.inv_q_last_mod_q = None
            return
        q_last = moduli[-1]
        half = q_last >> 1
        inv = []
        for qi in moduli[:-1]:
            r = numth.try_invert_uint_mod(q_last % qi, qi)
            if r is None:
                raise ValueError("invalid rns bases")
            inv.append(r)
        col = lambda v: to_tensor(np.array(v, dtype=np.uint64).reshape(-1, 1), device)
        self.inv_q_last_mod_q = col(inv)
        self.half_last = col([half])
        self.half_mod_qi = col([half % qi for qi in moduli[:-1]])
        self.zero_rest = col([0] * (L - 1))


def divide_and_round_q_last_ntt(x, tool: DeviceRNSTool, tables: NTTTables):
    """Drop the last limb with rounding, NTT-domain input and output
    (reference: rns.cpp:777-851): iNTT the last limb, add q_last/2 and
    reduce, lift it into each remaining limb, subtract q_last/2 there,
    forward-NTT, subtract from the rest and multiply by q_last^{-1}.
    [..., L, N] -> [..., L-1, N]."""
    L = x.shape[-2]
    q = tool.q_limbs
    last_l, rest_l = q.slice(L - 1, L), q.slice(0, L - 1)
    rest = x[..., : L - 1, :].contiguous()
    last = ntt_inverse(x[..., L - 1 : L, :].contiguous(), _slice_tables(tables, L - 1, L))
    last = rns_elementwise("barrett64", last, last_l.p, last_l.ratio0, last_l.ratio1,
                           b=tool.half_last)
    lifted = last.expand(last.shape[:-2] + (L - 1, last.shape[-1])).contiguous()
    lifted = rns_elementwise("barrett64", lifted, rest_l.p, rest_l.ratio0,
                             rest_l.ratio1, b=tool.zero_rest)
    temp = rns_elementwise("sub", lifted, rest_l.p, rest_l.ratio0, rest_l.ratio1,
                           b=tool.half_mod_qi)
    temp = ntt_forward(temp, _slice_tables(tables, 0, L - 1))
    diff = rns_elementwise("sub", rest, rest_l.p, rest_l.ratio0, rest_l.ratio1, b=temp)
    return rns_elementwise("mul", diff, rest_l.p, rest_l.ratio0, rest_l.ratio1,
                           b=tool.inv_q_last_mod_q)
