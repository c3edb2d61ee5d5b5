"""Limb-sharded hybrid key switching on the one-gather schedule.

Port of gemini_seal_tpu/parallel/keyswitch_sp.py.  Each rank of the limb
group owns n_ct / C contiguous NORMAL limb rows of the ciphertext:

- mod-up needs every rank to read all limbs of the power-basis target once,
  so a switch issues exactly ONE ``all_gather``: of the (per-limb
  inverse-NTT'd) target, n_ct rows per rank;
- each rank then computes the digit rows, the key inner product and the
  special-prime rescale of ITS OWN rows locally; the nsp special rows are
  computed redundantly on every rank instead of exchanged.

:func:`ckks_mul_relin_rescale_limb_sharded` composes the serving step on
the same schedule: the tensor product is limb-local, the relinearization
costs the one gather, and the rescale adds one 2-row ``psum`` that
broadcasts the rounded q_last limb from its owner (the last rank).

Each function is one rank's body: its rows of the ciphertext in, its rows
out, on a limb group (the group's ``limb`` axis, or the whole group; a
``dp`` axis splits the batch and moves no bytes).  Every rank's row-sliced
constants and key rows are built once per (plan, group layout, keys) and
cached on the plan, at most eight entries (the JAX ``_plan_consts``).
Bit-exact with the in-core ops, except that the pipeline's dropped q_last
row is returned zeroed (:func:`ckks_mul_relin_rescale_limb_sharded`).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..models.pipelines import _tensor_product
from ..ops.backend import to_tensor
from ..ops.dyadic import LimbConstants
from ..ops.galois import galois_permute
from ..ops.keyswitch import KeySwitchPlan
from ..ops.modops import contract_mulmod_128, rns_elementwise
from ..ops.ntt import ntt_forward, ntt_forward_lazy, ntt_inverse, ntt_inverse_lazy
from ..ops.rnsops import _dot_mod_128, _slice_tables
from .mesh import limb_group

__all__ = ["switch_key_limb_sharded", "ckks_mul_relin_rescale_limb_sharded",
           "rotate_many_limb_sharded", "plan_consts", "hoist_digits", "sp_fold",
           "switch_local"]

_CACHE_LOCK = threading.Lock()
MAX_CACHED = 8


class _RankConsts:
    """One rank's constants for a plan: its rows [lo, hi) of every table."""

    def __init__(self, plan: KeySwitchPlan, C: int, d: int, key):
        n_ct, nsp = plan.n_ct_rns, plan.n_sp_rns
        n_ct_all = plan.n_ct_all_rns
        rpn = n_ct // C
        lo, hi = d * rpn, (d + 1) * rpn
        nb = plan.n_bundles
        self.rpn = rpn
        self.tab = _slice_tables(plan.ext_tables, lo, hi)
        self.limbs = plan.ct_limbs.slice(lo, hi)
        # mod-up weights [nb, s_max, rows, 1]: own rows, and the special rows
        self.w_own = plan.bundle_w[:, :, lo:hi].contiguous()
        self.w_sp = plan.bundle_w[:, :, n_ct:].contiguous()
        self.diag = plan.bundle_diag[:, lo:hi].contiguous()
        self.neg_hat = plan.neg_hat_pj_qi[lo:hi].contiguous()     # [rpn, nsp]
        self.inv_p = plan.inv_P_qi[lo:hi].contiguous()            # [rpn, 1]
        # key rows: [..., nb, 2, rows, N] -> per component [..., nb, rows, N]
        k = key[..., :nb, :, :, :]
        self.key_own = [k[..., :, l, lo:hi, :].contiguous() for l in range(2)]
        self.key_sp = [k[..., :, l, n_ct_all:n_ct_all + nsp, :].contiguous() for l in range(2)]
        # the rescale by q_last (rns.cpp:719-729 constants, padded to n_ct
        # rows: the dropped row's entries are dummies, its output is zeroed)
        if n_ct >= 2:
            tool = plan.device_rns_tool
            q = [int(v) for v in tool.host.base_q.values()]
            q_last = q[-1]
            half = q_last >> 1
            inv_q = list(np.asarray(tool.host.inv_q_last_mod_q, dtype=np.uint64)) + [1]
            dev = plan.device
            self.inv_q_last = to_tensor(np.array(inv_q[lo:hi], dtype=np.uint64)
                                        .reshape(-1, 1), dev)
            self.half_mod = to_tensor(np.array([half % p for p in q[lo:hi]], dtype=np.uint64)
                                      .reshape(-1, 1), dev)
            self.zero = torch.zeros((rpn, 1), dtype=torch.int64, device=dev)
            self.last_tab = _slice_tables(self.tab, rpn - 1, rpn)
            self.q_last_limbs = LimbConstants.from_moduli([q_last], dev)
            self.half_last = to_tensor(np.array([[half]], dtype=np.uint64), dev)


def plan_consts(plan: KeySwitchPlan, C: int, d: int, key) -> _RankConsts:
    """Rank d of C's constants and key rows for `plan` and `key`, built once
    and cached on the plan (at most eight (layout, keys) entries, the
    oldest evicted)."""
    with _CACHE_LOCK:
        cache = plan.__dict__.setdefault("_sp_consts_cache", {})
        ckey = (C, id(key))
        hit = cache.get(ckey)
        if hit is None or hit[0] is not key:
            if len(cache) >= MAX_CACHED:
                cache.pop(next(iter(cache)))
            hit = cache[ckey] = (key, {})
        per_rank = hit[1]
        c = per_rank.get(d)
    if c is None:
        c = _RankConsts(plan, C, d, key)
        with _CACHE_LOCK:
            per_rank[d] = c
    return c


def _check(plan: KeySwitchPlan, C: int):
    if plan.n_ct_rns % C:
        raise ValueError(f"n_ct={plan.n_ct_rns} not divisible by limb={C}")


def _modup_rows(power_target, diag_src, plan: KeySwitchPlan, w, limbs, tables, diag):
    """Digit rows [..., nb, rows, N] of the rows that `w` (weights), `limbs`
    and `tables` describe; the bundle-diagonal rows take diag_src (none for
    the special rows)."""
    nb, s_max = plan.bundle_shape
    N = power_target.shape[-1]
    x_sel = power_target.index_select(-2, plan.bundle_sel)
    x_sel = x_sel.reshape(power_target.shape[:-2] + (nb, s_max, 1, N))
    lifted = contract_mulmod_128(x_sel, w, limbs.p.reshape(-1), limbs.ratio0.reshape(-1),
                                 limbs.ratio1.reshape(-1), prescale=plan.bundle_prescale)
    if plan.lazy_digits:
        lifted_ntt = ntt_forward_lazy(lifted, tables)
    else:
        lifted_ntt = ntt_forward(lifted, tables)
    if diag_src is None:
        return lifted_ntt
    return torch.where(diag, diag_src[..., None, :, :], lifted_ntt)


def hoist_digits(tgt_local, c: _RankConsts, plan: KeySwitchPlan, lg, is_ntt_form: bool):
    """The mod-up of this rank's rows: one all_gather of the power-basis
    target, then the digit rows of the own and (redundantly) the special
    limbs.  Returns (dig_own [..., nb, rpn, N], dig_sp [..., nb, nsp, N])."""
    tgt_local = tgt_local.contiguous()
    if is_ntt_form:
        pt_local = ntt_inverse_lazy(tgt_local, c.tab)
        diag_src = tgt_local
    else:
        pt_local = tgt_local
        diag_src = (ntt_forward_lazy if plan.lazy_digits else ntt_forward)(tgt_local, c.tab)
    power_target = lg.all_gather(pt_local, axis=-2)     # the switch's one collective
    dig_own = _modup_rows(power_target, diag_src, plan, c.w_own, c.limbs, c.tab, c.diag)
    dig_sp = _modup_rows(power_target, None, plan, c.w_sp, plan.sp_limbs, plan.sp_tables, None)
    return dig_own, dig_sp


def _inner(digits, key_rows, limbs: LimbConstants):
    """sum_b digits[..., b, rows, N] * key_rows[..., b, rows, N] mod p: one
    contraction.  digits [..., G|1, nb, rows, N] with key_rows [G, nb, rows,
    N] (G rotations) gives [..., G, rows, N]."""
    return contract_mulmod_128(digits, key_rows, limbs.p.reshape(-1), limbs.ratio0.reshape(-1),
                               limbs.ratio1.reshape(-1))


def sp_fold(acc_own, acc_sp, c: _RankConsts, plan: KeySwitchPlan, is_ntt_form: bool):
    """The special-prime rescale of this rank's rows (rescale_special, row
    sliced): fold the redundant special-row accumulator into the own rows
    and divide by P."""
    sl = plan.sp_limbs
    sp_power = ntt_inverse_lazy(acc_sp.contiguous(), plan.sp_tables)
    temp = _dot_mod_128(sp_power, c.neg_hat, c.limbs,
                        prescale=(plan.inv_hat_pj_pj, sl.p.reshape(-1),
                                  sl.ratio0.reshape(-1), sl.ratio1.reshape(-1)))
    normal = acc_own.contiguous()
    if is_ntt_form:
        temp = ntt_forward(temp, c.tab)
    else:
        normal = ntt_inverse(normal, c.tab)
    q = c.limbs
    return rns_elementwise("addmul", normal, q.p, q.ratio0, q.ratio1, b=temp, s=c.inv_p)


def _inner_rescale(dig_own, dig_sp, key_own, key_sp, c: _RankConsts, plan: KeySwitchPlan,
                   is_ntt_form: bool):
    """Key inner product and special-prime rescale on this rank's rows.
    dig_*: [..., G, nb, rows, N]; key_*: per component [G, nb, rows, N]."""
    outs = []
    for l in range(2):
        acc_own = _inner(dig_own, key_own[l], c.limbs)
        acc_sp = _inner(dig_sp, key_sp[l], plan.sp_limbs)
        outs.append(sp_fold(acc_own, acc_sp, c, plan, is_ntt_form))
    return outs[0], outs[1]


def switch_local(tgt_local, c: _RankConsts, plan: KeySwitchPlan, lg, is_ntt_form: bool):
    """The per-rank switch body: one all_gather, everything else local.
    Returns (d0, d1) for this rank's rows."""
    dig_own, dig_sp = hoist_digits(tgt_local, c, plan, lg, is_ntt_form)
    key_own = [k.unsqueeze(0) for k in c.key_own]
    key_sp = [k.unsqueeze(0) for k in c.key_sp]
    d0, d1 = _inner_rescale(dig_own.unsqueeze(-4), dig_sp.unsqueeze(-4), key_own, key_sp, c,
                            plan, is_ntt_form)
    return d0.squeeze(-3), d1.squeeze(-3)


def switch_key_limb_sharded(target_local, key_vector_data, plan: KeySwitchPlan, group,
                            is_ntt_form: bool = True):
    """Hybrid key switch of this rank's rows (keyswitch_sp.py:281-317).

    target_local: int64[..., n_ct / C, N], this rank's rows of the target in
    the ciphertext domain (NTT iff is_ntt_form: CKKS; BFV's power basis
    otherwise); key_vector_data: int64[nb, 2, L_key, N] (every rank's copy).
    Returns (d0, d1), this rank's rows in the ciphertext domain, equal to
    the rows of ops.keyswitch.switch_key.  One all_gather of n_ct rows."""
    lg = limb_group(group)
    _check(plan, lg.size)
    c = plan_consts(plan, lg.size, lg.rank, key_vector_data)
    return switch_local(target_local, c, plan, lg, is_ntt_form)


def rotate_many_limb_sharded(ct_local, keys_stack, elts, galois_tool, plan: KeySwitchPlan,
                             group, is_ntt_form: bool = True):
    """Hoisted rotations of this rank's rows on the one-gather schedule
    (keyswitch_sp.py:320-398): one mod-up (one all_gather) shared by every
    Galois element; the permutations act along the unsharded N axis.

    ct_local: int64[..., 2, n_ct / C, N] (NTT form iff is_ntt_form);
    keys_stack: int64[k, nb, 2, L_key, N] in `elts` order.  Returns
    int64[..., k, 2, n_ct / C, N], this rank's rows of
    Evaluator.apply_galois_many's ciphertexts."""
    lg = limb_group(group)
    _check(plan, lg.size)
    elts = [int(e) for e in elts]
    if keys_stack.shape[0] != len(elts):
        raise ValueError("keys_stack leading axis must match elts")
    c = plan_consts(plan, lg.size, lg.rank, keys_stack)
    ct_local = ct_local.contiguous()
    c0 = ct_local[..., 0, :, :].contiguous()
    dig_own, dig_sp = hoist_digits(ct_local[..., 1, :, :], c, plan, lg, is_ntt_form)
    tabs = galois_tool.ntt_tables(elts)                         # [k, N]
    R, nb, N = len(elts), plan.n_bundles, ct_local.shape[-1]
    lead = dig_own.shape[:-3]
    # one launch per digit set permutes it for every element: [..., k, nb, rows, N]
    dgo = galois_permute(dig_own.reshape(lead + (-1, N)), tabs).reshape(
        lead + (R, nb, c.rpn, N))
    dgs = galois_permute(dig_sp.reshape(lead + (-1, N)), tabs).reshape(
        lead + (R, nb, plan.n_sp_rns, N))
    d0, d1 = _inner_rescale(dgo, dgs, c.key_own, c.key_sp, c, plan, is_ntt_form)
    if is_ntt_form:
        p0 = galois_permute(c0, tabs)                           # [..., k, rows, N]
    else:
        p0 = galois_permute(c0, galois_tool.coeff_tables(elts), c.limbs.p)
    q = c.limbs
    nc0 = rns_elementwise("add", p0, q.p, q.ratio0, q.ratio1, b=d0)
    return torch.stack([nc0, d1], dim=-3)


def ckks_mul_relin_rescale_limb_sharded(a_local, b_local, key_vector_data,
                                        plan: KeySwitchPlan, group):
    """The CKKS serving step (multiply + relinearize + rescale) on this
    rank's rows (keyswitch_sp.py:401-486).

    a_local, b_local: int64[..., 2, n_ct / C, N], NTT form.  Returns
    int64[..., 2, n_ct / C, N] at the next level: rows [: n_ct - 1] of the
    joined result equal models.pipelines.build_ckks_mul_relin_rescale's;
    the dropped q_last row (the last rank's last row) comes back zeroed.
    Per step: one all_gather of the c2 target (n_ct rows) and one 2-row
    psum of the rounded q_last limb."""
    lg = limb_group(group)
    C, d = lg.size, lg.rank
    _check(plan, C)
    if plan.n_ct_rns < 2:
        raise ValueError("the rescale needs at least two ct primes")
    c = plan_consts(plan, C, d, key_vector_data)
    q = c.limbs
    c0, c1, c2 = _tensor_product(a_local.contiguous(), b_local.contiguous(), q)
    d0, d1 = switch_local(c2, c, plan, lg, True)
    u = torch.stack([rns_elementwise("add", c0, q.p, q.ratio0, q.ratio1, b=d0),
                     rns_elementwise("add", c1, q.p, q.ratio0, q.ratio1, b=d1)], dim=-3)
    rpn = c.rpn
    # the owner of q_last inverse-NTTs its last row; a masked psum broadcasts
    # that one row (per component) to every rank
    if d == C - 1:
        cand = ntt_inverse(u[..., rpn - 1:rpn, :].contiguous(), c.last_tab)
    else:
        cand = torch.zeros(u.shape[:-2] + (1, u.shape[-1]), dtype=u.dtype, device=u.device)
    last = lg.psum(cand)                                        # [..., 2, 1, N]
    ql = c.q_last_limbs
    last = rns_elementwise("barrett64", last, ql.p, ql.ratio0, ql.ratio1, b=c.half_last)
    lifted = last.expand(last.shape[:-2] + (rpn, last.shape[-1])).contiguous()
    lifted = rns_elementwise("barrett64", lifted, q.p, q.ratio0, q.ratio1, b=c.zero)
    temp = rns_elementwise("sub", lifted, q.p, q.ratio0, q.ratio1, b=c.half_mod)
    temp = ntt_forward(temp, c.tab)
    diff = rns_elementwise("sub", u, q.p, q.ratio0, q.ratio1, b=temp)
    out = rns_elementwise("mul", diff, q.p, q.ratio0, q.ratio1, b=c.inv_q_last)
    if d == C - 1:
        out[..., rpn - 1, :] = 0
    return out
