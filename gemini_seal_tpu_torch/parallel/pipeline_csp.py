"""Coefficient-sharded (sequence-parallel) serving pipeline.

Port of gemini_seal_tpu/parallel/pipeline_csp.py: the NTT-SP transforms
composed end to end.  Every non-NTT op of the hot step (the tensor
product, the mod-up contraction over limbs, the key inner product over
bundles, the rescale corrections) is elementwise over N and so local when
the coefficient axis is sharded; the only communication is inside each
NTT, whose four-step schedule costs two ``all_to_all`` transposes.

The in-core key switch and rescale (ops.keyswitch, ops.rnsops) take an
NTT strategy (``keyswitch.NTTOps``); this module passes one whose four
entry points are the four-step bodies of parallel/ntt_sp.py and runs the
UNCHANGED in-core dataflow on each rank's chunk of N.  A Galois rotation
is one block exchange (``ppermute``) and a local gather (K5) on the chunk's
own index (:func:`galois_block_plan`).

Each function is one rank's body: its chunk [..., N / C] of every
ciphertext and key in, its chunk of the result out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pipelines import _tensor_product
from ..ops.galois import galois_permute
from ..ops.keyswitch import (KeySwitchPlan, NTTOps, compute_modup_digits,
                             keyswitch_inner_product, switch_key)
from ..ops.modops import rns_elementwise
from ..ops.rnsops import divide_and_round_q_last_ntt
from .ntt_sp import check_4step, forward_4step_local, inverse_4step_local

__all__ = ["CoeffShardedNTT", "galois_block_plan", "switch_key_coeff_sharded",
           "ckks_mul_relin_rescale_coeff_sharded", "ckks_rotate_coeff_sharded",
           "ckks_rotate_many_coeff_sharded"]


class CoeffShardedNTT(NTTOps):
    """NTT strategy whose four entry points are the four-step bodies over
    `group` (the coefficient axis)."""

    def __init__(self, group):
        self.group = group

    def forward(self, x, tables):
        return forward_4step_local(x, tables, self.group)

    def forward_lazy(self, x, tables):
        return forward_4step_local(x, tables, self.group, lazy=True)

    def inverse(self, x, tables):
        return inverse_4step_local(x, tables, self.group)

    def inverse_lazy(self, x, tables):
        return inverse_4step_local(x, tables, self.group, lazy=True)


def galois_block_plan(galois_tool, elt: int, C: int):
    """The NTT-domain Galois permutation under C contiguous coefficient
    chunks is ONE block exchange and a LOCAL gather (pipeline_csp.py:70-99):
    output block b reads input block src[b] entirely.

    Returns (perm, lidx): perm = [(src rank, dst rank)] (None when the block
    map is the identity; it need not be symmetric), lidx = int64[N] local
    gather indices (rank r takes lidx[r B : (r + 1) B], B = N / C)."""
    n = galois_tool.coeff_count
    if n % C != 0:
        raise ValueError("N not divisible by coeff shards")
    B = n // C
    table = galois_tool._ntt_table(elt)
    src_block = table.reshape(C, B) // B
    if not np.all(src_block == src_block[:, :1]):
        raise AssertionError("Galois block-locality violated")
    src = src_block[:, 0]
    if sorted(src.tolist()) != list(range(C)):
        raise AssertionError("Galois block map not bijective")
    perm = None if np.array_equal(src, np.arange(C)) else [(int(src[b]), b) for b in range(C)]
    return perm, (table % B).astype(np.int64)


def _permute_local(x_local, tab_local, perm, group):
    """A block-planned Galois permutation of this rank's chunk: the block
    exchange, then one K5 gather by the local table [R, B] (R = 1: the
    rotation axis is dropped)."""
    y = x_local if perm is None else group.ppermute(x_local.contiguous(), perm)
    out = galois_permute(y.contiguous(), tab_local)
    return out.squeeze(-3) if tab_local.shape[0] == 1 else out


def switch_key_coeff_sharded(target_local, key_local, plan: KeySwitchPlan, group,
                             is_ntt_form: bool = True):
    """Hybrid key switch of this rank's coefficient chunk
    (pipeline_csp.py:110-137).

    target_local: int64[..., n_ct, N / C]; key_local: int64[nb, 2, L_key,
    N / C] (the key's same chunk).  Returns (d0, d1) chunks, equal to
    ops.keyswitch.switch_key's.  Two all_to_alls per NTT, nothing else."""
    check_4step(plan.ct_tables.coeff_count, group.size)
    return switch_key(target_local.contiguous(), key_local, plan, is_ntt_form,
                      ntt=CoeffShardedNTT(group))


def ckks_mul_relin_rescale_coeff_sharded(a_local, b_local, key_local, plan: KeySwitchPlan,
                                         group):
    """The CKKS step (multiply + relinearize + rescale) on this rank's
    coefficient chunk (pipeline_csp.py:140-175).

    a_local, b_local: int64[..., 2, n_ct, N / C], NTT form.  Returns
    int64[..., 2, n_ct - 1, N / C] at the next level, equal chunk for chunk
    to models.pipelines.build_ckks_mul_relin_rescale's step."""
    check_4step(plan.ct_tables.coeff_count, group.size)
    nttops = CoeffShardedNTT(group)
    q = plan.ct_limbs
    c0, c1, c2 = _tensor_product(a_local.contiguous(), b_local.contiguous(), q)
    d0, d1 = switch_key(c2, key_local, plan, True, ntt=nttops)
    u = torch.stack([rns_elementwise("add", c0, q.p, q.ratio0, q.ratio1, b=d0),
                     rns_elementwise("add", c1, q.p, q.ratio0, q.ratio1, b=d1)], dim=-3)
    return divide_and_round_q_last_ntt(u, plan.device_rns_tool, plan.ct_tables, ntt=nttops)


def ckks_rotate_coeff_sharded(ct_local, key_local, elt: int, galois_tool,
                              plan: KeySwitchPlan, group):
    """One CKKS rotation (apply_galois + key switch) of this rank's chunk
    (pipeline_csp.py:178-217): the automorphism costs at most one ppermute
    (galois_block_plan), then the switch its all_to_alls.  NTT form only."""
    C = group.size
    check_4step(plan.ct_tables.coeff_count, C)
    perm, tab = _block_plan(galois_tool, [int(elt)], C, group.rank, ct_local.device)
    q = plan.ct_limbs
    rot = _permute_local(ct_local, tab, perm[0], group)
    d0, d1 = switch_key(rot[..., 1, :, :].contiguous(), key_local, plan, True,
                        ntt=CoeffShardedNTT(group))
    p0 = rot[..., 0, :, :].contiguous()
    return torch.stack([rns_elementwise("add", p0, q.p, q.ratio0, q.ratio1, b=d0), d1], dim=-3)


def ckks_rotate_many_coeff_sharded(ct_local, keys_local, elts, galois_tool,
                                   plan: KeySwitchPlan, group):
    """Hoisted rotations of this rank's chunk (pipeline_csp.py:220-271): one
    mod-up (its NTTs are the all_to_all part), then per element one block
    exchange of the digits and of c0 and the local inner product and
    rescale.  keys_local: int64[k, nb, 2, L_key, N / C].  Returns
    int64[..., k, 2, n_ct, N / C]."""
    C = group.size
    check_4step(plan.ct_tables.coeff_count, C)
    elts = [int(e) for e in elts]
    if keys_local.shape[0] != len(elts):
        raise ValueError("keys_stack leading axis must match elts")
    nttops = CoeffShardedNTT(group)
    perms, tabs = _block_plan(galois_tool, elts, C, group.rank, ct_local.device)
    q = plan.ct_limbs
    ct_local = ct_local.contiguous()
    c0 = ct_local[..., 0, :, :].contiguous()
    ct_k = compute_modup_digits(ct_local[..., 1, :, :], plan, True, ntt=nttops)  # hoisted
    outs = []
    for i in range(len(elts)):
        tab = tabs[i: i + 1]
        dig = _permute_local(ct_k, tab, perms[i], group)
        d0, d1 = keyswitch_inner_product(dig, keys_local[i], plan, True, ntt=nttops)
        p0 = _permute_local(c0, tab, perms[i], group)
        outs.append(torch.stack([rns_elementwise("add", p0, q.p, q.ratio0, q.ratio1, b=d0),
                                 d1], dim=-3))
    return torch.stack(outs, dim=-4)


def _block_plan(galois_tool, elts, C: int, rank: int, device):
    """(perms, this rank's local gather tables int64[k, N / C] on `device`)
    of the elements, built once per (elements, C, rank, device)."""
    cache = galois_tool.__dict__.setdefault("_block_plans", {})
    key = (tuple(elts), C, rank, str(device))
    hit = cache.get(key)
    if hit is None:
        plans = [galois_block_plan(galois_tool, e, C) for e in elts]
        B = galois_tool.coeff_count // C
        lidx = np.stack([l[rank * B:(rank + 1) * B] for _, l in plans])
        hit = cache[key] = ([p for p, _ in plans], torch.from_numpy(lidx).to(device))
    return hit
