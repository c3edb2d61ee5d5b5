"""Limb-sharded bootstrap linear stages: the C2S/S2C hoisted matvec on the
one-gather key-switch schedule.

Port of gemini_seal_tpu/parallel/bootstrap_sp.py.  A CoeffToSlot or
SlotToCoeff group is a hoisted matvec (models.pipelines.build_ckks_matvec,
fused mod-down): one mod-up feeds every rotation, each rotated digit set
is inner-producted with its Galois key, multiplied by the group's
extended-base diagonal and summed, and the raw accumulators are mod-downed
once.  Each rank owns n_ct / C limb rows; the hoist costs one all_gather
of the inverse-NTT'd c1 (n_ct rows) per group, not per rotation, and every
rotation and diagonal product after it is row-local (the Galois
permutations act along the unsharded N axis; the special rows are computed
redundantly).  Bit-exact with build_ckks_matvec(fuse_moddown=True).
"""

from __future__ import annotations

import torch

from ..ops.galois import galois_permute
from ..ops.keyswitch import KeySwitchPlan
from ..ops.modops import contract_mulmod_128, rns_elementwise
from .keyswitch_sp import hoist_digits, plan_consts, sp_fold
from .mesh import limb_group

__all__ = ["build_ckks_matvec_limb_sharded"]


def _contract(a, w, limbs):
    return contract_mulmod_128(a.contiguous(), w, limbs.p.reshape(-1), limbs.ratio0.reshape(-1),
                               limbs.ratio1.reshape(-1))


def build_ckks_matvec_limb_sharded(context, diagonals, scale: float, encoder, C: int,
                                   parms_id=None, device=None):
    """The limb-sharded twin of build_ckks_matvec (fused mod-down) for C
    ranks of the limb axis (bootstrap_sp.py:61-194).

    diagonals: {step d: slot values}, at least one nonzero step.  Returns
    fn(group, ct_local, keys_stack) -> int64[..., 2, n_ct / C, N], this
    rank's rows at the same level with scale * scale; ct_local: the rank's
    rows [..., 2, n_ct / C, N]; keys_stack: int64[R, nb, 2, L_key, N] in
    sorted nonzero-step order.  fn.rot_steps lists those steps.  The
    diagonals are encoded once, on the context's device, and each rank's
    rows are cut from them at its first call.  device: the context's (None
    means the card)."""
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)
    n_ct = plan.n_ct_rns
    if n_ct % C:
        raise ValueError(f"n_ct={n_ct} not divisible by limb={C}")
    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    if not rot_steps:
        raise ValueError("need at least one nonzero diagonal to shard")
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    R = len(rot_steps)
    rot_tabs = tool.ntt_tables(elts)                                     # [R, N]
    encoded = encoder.encode_stack([list(diagonals[s]) for s in steps], scale, parms_id)
    plains = dict(zip(steps, encoded))
    ptc = torch.stack([plains[s] for s in rot_steps])                    # [R, n_ct, N]
    pt0 = plains.get(0)                                                  # [n_ct, N]
    pte = encoder.encode_stack([list(diagonals[s]) for s in rot_steps], scale, parms_id,
                               plan.ext_moduli, plan.ext_tables)         # [R, n_ext, N]
    rpn = n_ct // C
    per_rank = {}

    def rows(d):
        hit = per_rank.get(d)
        if hit is None:
            lo, hi = d * rpn, (d + 1) * rpn
            hit = per_rank[d] = {
                "ptc": ptc[:, lo:hi].contiguous().unsqueeze(0),          # [1, R, rpn, N]
                "pte_own": pte[:, lo:hi].contiguous().unsqueeze(0),
                "pte_sp": pte[:, n_ct:].contiguous().unsqueeze(0),
                "pt0": None if pt0 is None else pt0[lo:hi].contiguous(),
            }
        return hit

    def fn(group, ct_local, keys_stack):
        lg = limb_group(group)
        if lg.size != C:
            raise ValueError(f"built for {C} limb ranks, called on {lg.size}")
        d = lg.rank
        c = plan_consts(plan, C, d, keys_stack)
        dg = rows(d)
        q = c.limbs
        ct_local = ct_local.contiguous()
        c0 = ct_local[..., 0, :, :].contiguous()
        dig_own, dig_sp = hoist_digits(ct_local[..., 1, :, :], c, plan, lg, True)
        lead, nb, N = dig_own.shape[:-3], plan.n_bundles, ct_local.shape[-1]
        dgo = galois_permute(dig_own.reshape(lead + (-1, N)), rot_tabs).reshape(
            lead + (R, nb, rpn, N))
        dgs = galois_permute(dig_sp.reshape(lead + (-1, N)), rot_tabs).reshape(
            lead + (R, nb, plan.n_sp_rns, N))
        outs = []
        for l in range(2):
            a_own = _contract(dgo, c.key_own[l], q)                     # [..., R, rpn, N]
            a_sp = _contract(dgs, c.key_sp[l], plan.sp_limbs)
            raw_own = _contract(a_own.unsqueeze(-4), dg["pte_own"], q).squeeze(-3)
            raw_sp = _contract(a_sp.unsqueeze(-4), dg["pte_sp"], plan.sp_limbs).squeeze(-3)
            outs.append(sp_fold(raw_own, raw_sp, c, plan, True))
        rc = galois_permute(c0, rot_tabs)                                # [..., R, rpn, N]
        ct_part = _contract(rc.unsqueeze(-4), dg["ptc"], q).squeeze(-3)
        nc0 = rns_elementwise("add", ct_part, q.p, q.ratio0, q.ratio1, b=outs[0])
        nc1 = outs[1]
        if dg["pt0"] is not None:
            p0 = rns_elementwise("mul", ct_local, q.p, q.ratio0, q.ratio1, b=dg["pt0"])
            nc0 = rns_elementwise("add", p0[..., 0, :, :].contiguous(), q.p, q.ratio0,
                                  q.ratio1, b=nc0)
            nc1 = rns_elementwise("add", p0[..., 1, :, :].contiguous(), q.p, q.ratio0,
                                  q.ratio1, b=nc1)
        return torch.stack([nc0, nc1], dim=-3)

    fn.rot_steps = rot_steps
    return fn
