"""Limb-sharded BFV BEHZ multiply + relinearize.

Port of gemini_seal_tpu/parallel/behz_sp.py: BASELINE configs 1 and 3's
hot step on the same communication-minimal pattern as keyswitch_sp.py.

- each rank owns n_ct / C rows of the q base AND n_B / C rows of the B
  base (n_B == n_ct, so both split evenly);
- the two single extension rows (m_tilde for the Montgomery tag, m_sk for
  the Shenoy-Kumaresan correction) are computed redundantly on every rank
  from the gathered sources;
- every base conversion is ONE tiled all_gather of the pre-scaled source
  rows, then a local 128-bit-exact contraction onto the rank's own output
  rows (and the redundant single rows): one K3 launch;
- the whole multiply + relinearize runs in FIVE all_gathers: the two
  operand extensions (q -> B u {m_sk, m_tilde}), the fast_floor lift (q ->
  Bsk), the Shenoy-Kumaresan return (B -> q u {m_sk}) and the relin key
  switch's target.

Bit-exact with models.pipelines.build_bfv_mul_relin: the same lazy NTT
ranges and the same constants, row-sliced; two canonical multiplies by
per-limb constants are one multiply by their product (mod p), which the
pre-scale of an extension uses (m_tilde times the punctured inverse).
Each function is one rank's body on the group's limb axis.
"""

from __future__ import annotations

import threading
from dataclasses import fields, replace

import numpy as np
import torch

from ..models.pipelines import _tensor_product
from ..ops.backend import to_tensor
from ..ops.dyadic import LimbConstants
from ..ops.keyswitch import KeySwitchPlan
from ..ops.modops import rns_elementwise
from ..ops.ntt import NTTTables, ntt_forward_lazy, ntt_inverse
from ..ops.rnsops import _dot_mod_128, _pack, _slice_tables, behz
from .keyswitch_sp import plan_consts, switch_local
from .mesh import limb_group

__all__ = ["bfv_mul_relin_limb_sharded"]

_LOCK = threading.Lock()


def _rows_tables(t: NTTTables, idx) -> NTTTables:
    """The NTT tables of the rows `idx` (any order), contiguous."""
    sel = torch.tensor(list(idx), dtype=torch.int64, device=t.modulus.device)
    return replace(t, moduli=[t.moduli[i] for i in idx], **{
        f.name: getattr(t, f.name).index_select(0, sel).contiguous()
        for f in fields(t) if isinstance(getattr(t, f.name), torch.Tensor)})


def _col(vals, device):
    return to_tensor(np.asarray([int(v) for v in vals], dtype=np.uint64).reshape(-1, 1), device)


class _BehzConsts:
    """One rank's rows of the BEHZ constants (behz_sp.py:50-149): q rows
    [lo, hi) and B rows [lo, hi), with the m_sk row (Bsk row n_B) beside the
    B rows and the m_tilde row beside them for the extension."""

    def __init__(self, cd, C: int, d: int):
        tool = cd.device_rns_tool
        host = tool.host
        dev = cd.device
        n_ct = host.base_q.size
        n_b = host.base_B.size
        if n_ct % C or n_b % C:
            raise ValueError(f"n_ct={n_ct}/n_B={n_b} not divisible by limb={C}")
        rq, rb = n_ct // C, n_b // C
        qlo, qhi = d * rq, (d + 1) * rq
        blo, bhi = d * rb, (d + 1) * rb
        q = [int(v) for v in host.base_q.values()]
        bsk = [m.value for m in host.base_Bsk.base]
        m_tilde, m_sk, t = host.m_tilde.value, host.m_sk.value, host.t.value
        e_rows = list(range(blo, bhi)) + [n_b]          # own B rows, then m_sk
        self.rq = rq
        # q side
        self.tab_q = _slice_tables(cd.ntt_tables, qlo, qhi)
        self.q = tool.q_limbs.slice(qlo, qhi)
        invp_q = [int(v) for v in host.base_q_to_Bsk_conv.inv_punctured]
        self.mt_invp = _col([(m_tilde * invp_q[i]) % q[i] for i in range(qlo, qhi)], dev)
        self.invp = _col(invp_q[qlo:qhi], dev)
        self.t_q = _col([t % q[i] for i in range(qlo, qhi)], dev)
        # extension: q -> (own B, m_sk, m_tilde), then sm_mrq onto (own B, m_sk)
        mat_bsk = np.asarray(host.base_q_to_Bsk_conv.matrix)
        mat_mt = np.asarray(host.base_q_to_m_tilde_conv.matrix)
        self.ext_mat = to_tensor(np.concatenate([mat_bsk[e_rows], mat_mt]), dev)
        self.ext_limbs = LimbConstants.from_moduli([bsk[i] for i in e_rows] + [m_tilde], dev)
        self.e = LimbConstants.from_moduli([bsk[i] for i in e_rows], dev)
        self.tab_e = _rows_tables(tool.base_Bsk_ntt_tables, e_rows)
        bsk_mods = host.base_Bsk.base
        self.sm_mrq_consts = _pack(
            [[bsk_mods[i].value for i in e_rows], [bsk_mods[i].const_ratio[0] for i in e_rows],
             [bsk_mods[i].const_ratio[1] for i in e_rows],
             [host.prod_q_mod_Bsk[i] for i in e_rows],
             [host.inv_m_tilde_mod_Bsk[i] for i in e_rows],
             host.inv_prod_q_mod_m_tilde], dev)
        self.t_e = _col([t % bsk[i] for i in e_rows], dev)
        # fast_floor: q -> (own B, m_sk)
        self.floor_mat = to_tensor(mat_bsk[e_rows], dev)
        self.inv_prod_q = _col([host.inv_prod_q_mod_Bsk[i] for i in e_rows], dev)
        # fastbconv_sk: B -> (own q, m_sk), then the alpha correction
        self.b = LimbConstants.from_moduli([bsk[i] for i in range(blo, bhi)], dev)
        self.invp_b = _col([int(v) for v in host.base_B_to_q_conv.inv_punctured[blo:bhi]], dev)
        self.sk_mat = to_tensor(np.concatenate([np.asarray(host.base_B_to_q_conv.matrix)[qlo:qhi],
                                                np.asarray(host.base_B_to_m_sk_conv.matrix)]),
                                dev)
        self.sk_limbs = LimbConstants.from_moduli(q[qlo:qhi] + [m_sk], dev)
        qmods = host.base_q.base
        self.sk_tail_consts = _pack(
            [q[qlo:qhi], [qmods[i].const_ratio[0] for i in range(qlo, qhi)],
             [qmods[i].const_ratio[1] for i in range(qlo, qhi)],
             [host.prod_B_mod_q[i] for i in range(qlo, qhi)], m_sk, host.m_sk.const_ratio[0],
             host.m_sk.const_ratio[1], host.inv_prod_B_mod_m_sk], dev)


def _behz_consts(cd, C: int, d: int) -> _BehzConsts:
    """Rank d of C's BEHZ constants, built once per (level, C, rank)."""
    with _LOCK:
        cache = cd.__dict__.setdefault("_behz_sp_cache", {})
        c = cache.get((C, d))
    if c is None:
        c = _BehzConsts(cd, C, d)
        with _LOCK:
            cache[(C, d)] = c
    return c


def bfv_mul_relin_limb_sharded(a_local, b_local, key_vector_data, context, group,
                               parms_id=None, plan: KeySwitchPlan = None):
    """BFV BEHZ multiply + relinearize of this rank's rows
    (behz_sp.py:152-317).

    a_local, b_local: int64[..., 2, n_ct / C, N], power basis;
    key_vector_data: int64[nb, 2, L_key, N] (every rank's copy).  Returns
    int64[..., 2, n_ct / C, N], this rank's rows of
    build_bfv_mul_relin(context)(a, b, key).  Five all_gathers."""
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    if plan is None:
        plan = KeySwitchPlan(context, parms_id)
    lg = limb_group(group)
    C, d = lg.size, lg.rank
    c = _behz_consts(cd, C, d)
    kc = plan_consts(plan, C, d, key_vector_data)
    q, e = c.q, c.e
    rq = c.rq

    def extend(x):
        """x: [..., 2, own q, N] power basis -> (q_ntt, (own B, m_sk)_ntt)."""
        x = x.contiguous()
        q_ntt = ntt_forward_lazy(x, c.tab_q)
        scaled = rns_elementwise("mul", x, q.p, q.ratio0, q.ratio1, b=c.mt_invp)
        g = lg.all_gather(scaled, axis=-2)                        # [..., 2, n_ct, N]
        ext = _dot_mod_128(g, c.ext_mat, c.ext_limbs)            # (own B, m_sk, m_tilde)
        return q_ntt, ntt_forward_lazy(behz("sm_mrq", ext, c.sm_mrq_consts), c.tab_e)

    aq, ae = extend(a_local)
    bq, be = extend(b_local)
    dq = _tensor_product(aq, bq, q)                                # [3, ..., own q, N]
    de = _tensor_product(ae, be, e)                                # [3, ..., own B + 1, N]
    tq = rns_elementwise("mul", ntt_inverse(dq, c.tab_q), q.p, q.ratio0, q.ratio1, b=c.t_q)
    te = rns_elementwise("mul", ntt_inverse(de, c.tab_e), e.p, e.ratio0, e.ratio1, b=c.t_e)

    # fast_floor (rns.cpp:983-1023): q -> (own B, m_sk) conversion of tq
    scaled_tq = rns_elementwise("mul", tq, q.p, q.ratio0, q.ratio1, b=c.invp)
    g = lg.all_gather(scaled_tq, axis=-2)                         # [3, ..., n_ct, N]
    conv = _dot_mod_128(g, c.floor_mat, e)
    floor = rns_elementwise("submul", te, e.p, e.ratio0, e.ratio1, b=conv, s=c.inv_prod_q)

    # fastbconv_sk (rns.cpp:853-923): B -> (own q, m_sk), x_sk local
    b = c.b
    scaled_fl = rns_elementwise("mul", floor[..., :rq, :].contiguous(), b.p, b.ratio0,
                                b.ratio1, b=c.invp_b)
    g2 = lg.all_gather(scaled_fl, axis=-2)                        # [3, ..., n_B, N]
    conv2 = _dot_mod_128(g2, c.sk_mat, c.sk_limbs)
    out = behz("sk_tail", conv2, c.sk_tail_consts, aux=floor)     # [3, ..., own q, N]

    # relinearize: the power-basis switch of component 2 (the fifth gather)
    d0, d1 = switch_local(out[2], kc, plan, lg, False)
    return torch.stack([rns_elementwise("add", out[0], q.p, q.ratio0, q.ratio1, b=d0),
                        rns_elementwise("add", out[1], q.p, q.ratio0, q.ratio1, b=d1)], dim=-3)
