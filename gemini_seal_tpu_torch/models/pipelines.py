"""Evaluation pipelines over raw ciphertext tensors.

Port of these steps of gemini_seal_tpu/models/pipelines.py: CKKS multiply
+ relinearize + rescale (sequential and fused forms), rotate, the hoisted
multi-rotation step and the flagship train step (multiply + relinearize +
rescale, rotate, add); the BFV (BEHZ) multiply + relinearize and its
mod-switch chain.  Every step takes ciphertext data shaped
[..., size, L, N] with any leading batch axes, as the JAX functions do.
PyTorch runs eagerly; each modular-arithmetic stage is one launch of a
hand-written kernel (``tensor_product``, ``ntt``, ``contract``,
``elementwise``, ``galois``, ``behz``) on the context's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..context import SealContext
from ..ops import cuda
from ..ops.backend import is_cuda
from ..ops.dyadic import LimbConstants, add_poly, multiply_poly_scalar
from ..ops.galois import galois_permute
from ..ops.keyswitch import (KeySwitchPlan, batched_rotated_inner_product,
                             compute_modup_digits, fused_moddown,
                             keyswitch_inner_product, rescale_special, switch_key)
from ..ops.modops import add_mod, mul_mod
from ..ops.ntt import ntt_forward_lazy, ntt_inverse
from ..ops.rnsops import (MultiDropPlan, divide_and_round_multi, divide_and_round_q_last,
                          divide_and_round_q_last_ntt, fast_floor, fastbconv_m_tilde,
                          fastbconv_sk, sm_mrq)

__all__ = ["build_ckks_mul_relin_rescale", "build_ckks_rotate",
           "build_ckks_rotate_many", "build_ckks_train_step", "build_bfv_mul_relin",
           "build_bfv_mul_relin_modswitch", "tensor_product_plain"]


def tensor_product_plain(a, b, limbs: LimbConstants):
    """Plain version of the ``tensor_product`` kernel: _convolve3
    (b given) or _square3 (b None) of the JAX package
    (pipelines.py:72-99), with dyadic_product = mul_mod and add_poly =
    add_mod."""
    p, r0, r1 = limbs.p, limbs.ratio0, limbs.ratio1
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    if b is None:
        cross = mul_mod(a0, a1, p, r0, r1)
        return torch.stack([mul_mod(a0, a0, p, r0, r1), add_mod(cross, cross, p),
                            mul_mod(a1, a1, p, r0, r1)])
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
    c1 = add_mod(mul_mod(a0, b1, p, r0, r1), mul_mod(a1, b0, p, r0, r1), p)
    return torch.stack([mul_mod(a0, b0, p, r0, r1), c1, mul_mod(a1, b1, p, r0, r1)])


def _tensor_product(a, b, limbs: LimbConstants):
    """The three components (c0, c1, c2) of a size-2 x size-2 product (b
    None: square a), stacked: int64[3, ..., L, N], so that a step can
    unpack them or transform all three in one launch.

    a, b: int64[..., 2, L, N] of one shape."""
    if not is_cuda(*(t for t in (a, b, limbs.p) if t is not None)):
        return tensor_product_plain(a, b, limbs)
    if a.dim() < 3 or a.shape[-3] != 2:
        raise ValueError(f"tensor_product: expected [..., 2, L, N], got {tuple(a.shape)}")
    if b is not None and b.shape != a.shape:
        raise ValueError("tensor_product: operands differ in shape")
    L, N = a.shape[-2:]
    if limbs.p.numel() != L:
        raise ValueError("tensor_product: modulus count does not match the limb axis")
    for t, what in ((a, "a"), (b, "b"), (limbs.p, "p"), (limbs.ratio0, "ratio0"),
                    (limbs.ratio1, "ratio1")):
        if t is not None:
            cuda.check(t, f"tensor_product {what}")
    out = torch.empty((3,) + a.shape[:-3] + (L, N), dtype=torch.int64, device=a.device)
    if a.numel() == 0:
        return out
    cuda.call("tensor_product", *(cuda.ptr(o) for o in out), cuda.ptr(a), cuda.ptr(b),
              a.numel() // (2 * L * N), L, N, cuda.ptr(limbs.p),
              cuda.ptr(limbs.ratio0), cuda.ptr(limbs.ratio1))
    return out


def build_ckks_mul_relin_rescale(context: SealContext, parms_id=None,
                                 fused: bool = False, square: bool = False,
                                 device=None) -> Callable:
    """fn(ct_a, ct_b, relin_key) -> next-level ciphertext data.

    ct_*: int64[..., 2, L, N] (NTT form); relin_key: int64[n_bundles, 2,
    L_key, N], all on the context's device (None means the card).  Returns
    int64[..., 2, L-1, N], bit-identical to the JAX package's step of the
    same form.

    fused=False (the JAX default): key switch with the special-prime
    rescale (switch_key), add, then divide_and_round_q_last_ntt.
    fused=True merges the rescale into the key-switch mod-down (one
    division by P*q_last): one NTT round trip per component saved; decrypts
    equal to the sequential form but is not bit-identical to it.

    square=True returns fn(ct, relin_key) using the 3-product square.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    plan = KeySwitchPlan(context, parms_id)

    def product(a, b):
        return _tensor_product(a.contiguous(), None if b is None else b.contiguous(), limbs)

    if fused:
        plan.fused_drop_constants()

        def step(a, b, relin_key):
            c0, c1, c2 = product(a, b)
            ct_k = compute_modup_digits(c2, plan, True)
            acc0, acc1 = keyswitch_inner_product(ct_k, relin_key, plan, True, raw=True)
            out0 = fused_moddown(c0, acc0, plan)
            out1 = fused_moddown(c1, acc1, plan)
            return torch.stack([out0, out1], dim=-3)
    else:
        tool = cd.device_rns_tool
        tables = cd.ntt_tables

        def step(a, b, relin_key):
            c0, c1, c2 = product(a, b)
            d0, d1 = switch_key(c2, relin_key, plan, True)
            ct = torch.stack([add_poly(c0, d0, limbs), add_poly(c1, d1, limbs)], dim=-3)
            return divide_and_round_q_last_ntt(ct, tool, tables)

    if square:
        return lambda a, relin_key: step(a, None, relin_key)
    return step


def build_ckks_rotate(context: SealContext, steps: int, parms_id=None,
                      device=None) -> Callable:
    """fn(ct, galois_key) -> rotated ciphertext data (same level).

    ct: int64[..., 2, L, N] (NTT form); galois_key: int64[n_bundles, 2,
    L_key, N], the key of the step's Galois element.  One ``galois`` launch
    permutes both components, then c1 is key-switched back to s.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    elt = tool.get_elt_from_step(steps)
    tool.ntt_tables([elt])  # upload the table now, not in the first step
    plan = KeySwitchPlan(context, parms_id)

    def step(ct, galois_key):
        rot = tool.apply_galois_ntt(ct, elt)
        d0, d1 = switch_key(rot[..., 1, :, :], galois_key, plan, True)
        return torch.stack([add_poly(rot[..., 0, :, :].contiguous(), d0, limbs), d1],
                           dim=-3)

    return step


def build_ckks_train_step(context: SealContext, rotate_steps: int = 1,
                          device=None) -> Callable:
    """The flagship composite step: multiply + relinearize + rescale (the
    sequential form) + rotate + add, the inner loop of encrypted
    dot-product / polynomial evaluation workloads.

    fn(ct_a, ct_b, relin_key, galois_key) -> int64[..., 2, L-1, N].
    """
    context.check_device(device)
    parms_id = context.first_parms_id
    mul_step = build_ckks_mul_relin_rescale(context, parms_id, device=device)
    next_id = context.get_context_data(parms_id).next_context_data.parms_id
    rot_step = build_ckks_rotate(context, rotate_steps, next_id, device=device)
    limbs = context.get_context_data(next_id).limb_constants

    def step(a, b, relin_key, galois_key):
        prod = mul_step(a, b, relin_key)
        rot = rot_step(prod, galois_key)
        return add_poly(prod, rot, limbs)

    return step


def build_ckks_rotate_many(context: SealContext, steps, parms_id=None,
                           prepermuted_keys: bool = False, device=None) -> Callable:
    """fn(ct, galois_keys_stack) -> [n_steps, ..., 2, L, N] rotated batch.

    Hoisted rotations: one mod-up digit decomposition feeds every step's
    key-switch inner product (batched_rotated_inner_product); c0 is
    permuted for every step in one ``galois`` launch.
    galois_keys_stack: int64[n_steps, n_bundles, 2, L_key, N], key(elt_i)
    for each step in order (GaloisKeys.stacked).  The result is a view
    with the step axis first, as the JAX function's moveaxis.

    prepermuted_keys=True (counter-rotated keys) is not ported yet.
    """
    context.check_device(device)
    if prepermuted_keys:
        raise NotImplementedError("build_ckks_rotate_many: prepermuted_keys=True is not "
                                  "ported yet")
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    rot_tabs = tool.ntt_tables(tool.get_elts_from_steps(list(steps)))
    plan = KeySwitchPlan(context, parms_id)

    def step(ct, keys_stack):
        ct_k = compute_modup_digits(ct[..., 1, :, :], plan, True)    # hoisted
        a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, keys_stack,
                                               plan)              # [..., R, n_ext, N]
        d0 = rescale_special(a0, plan, is_ntt_output=True)
        d1 = rescale_special(a1, plan, is_ntt_output=True)
        p0 = galois_permute(ct[..., 0, :, :].contiguous(), rot_tabs)  # [..., R, L, N]
        out = torch.stack([add_poly(p0, d0, limbs), d1], dim=-3)
        return out.movedim(-4, 0)                                 # [R, ..., 2, L, N]

    return step


def build_bfv_mul_relin(context: SealContext, parms_id=None, square: bool = False,
                        device=None) -> Callable:
    """fn(ct_a, ct_b, relin_key) -> size-2 ciphertext data (BFV, BEHZ):
    benchmark configs 1 and 3's hot step.

    ct_*: int64[..., 2, L, N] (power basis); relin_key: int64[n_bundles, 2,
    L_key, N], all on the context's device.  Returns int64[..., 2, L, N],
    bit-identical to the JAX package's step.

    Each operand is lifted to the NTT domain on q and, through
    fastbconv_m_tilde and sm_mrq, on Bsk; the three product components are
    then carried together ([3, ..., rows, N]) through the inverse NTTs, the
    multiply by t, fast_floor and fastbconv_sk, so each of those stages is
    one launch; c2 is relinearized by the power-basis switch_key.

    square=True returns fn(ct, relin_key): one base extension and the
    3-product square (reference: evaluator.cpp:560-706 bfv_square),
    bit-exact with the multiply on identical operands.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.device_rns_tool
    bsk_limbs = tool.Bsk_limbs
    bsk_tables = tool.base_Bsk_ntt_tables
    t = cd.parms.plain_modulus.value
    t_q = torch.full_like(limbs.p, t)
    t_bsk = torch.full_like(bsk_limbs.p, t)
    plan = KeySwitchPlan(context, parms_id)

    def extend(ct):
        # lazy [0, 4p) lifts into the tensor product's full-range Barrett
        # products, as in the JAX function
        ct = ct.contiguous()
        bsk = sm_mrq(fastbconv_m_tilde(ct, tool), tool)
        return ntt_forward_lazy(ct, cd.ntt_tables), ntt_forward_lazy(bsk, bsk_tables)

    def step(a, b, relin_key):
        aq, absk = extend(a)
        if b is None:
            dq = _tensor_product(aq, None, limbs)
            dbsk = _tensor_product(absk, None, bsk_limbs)
        else:
            bq, bbsk = extend(b)
            dq = _tensor_product(aq, bq, limbs)
            dbsk = _tensor_product(absk, bbsk, bsk_limbs)
        tq = multiply_poly_scalar(ntt_inverse(dq, cd.ntt_tables), t_q, limbs)
        tbsk = multiply_poly_scalar(ntt_inverse(dbsk, bsk_tables), t_bsk, bsk_limbs)
        c0, c1, c2 = fastbconv_sk(fast_floor(tq, tbsk, tool), tool)
        d0, d1 = switch_key(c2, relin_key, plan, False)
        return torch.stack([add_poly(c0, d0, limbs), add_poly(c1, d1, limbs)], dim=-3)

    if square:
        return lambda a, relin_key: step(a, None, relin_key)
    return step


def build_bfv_mul_relin_modswitch(context: SealContext, target_parms_id=None,
                                  fused_drop: bool = True, square: bool = False,
                                  device=None) -> Callable:
    """BFV multiply + relinearize + mod-switch down to `target_parms_id`
    (default: the chain's last level): benchmark config 3's full step.

    fused_drop=True uses one rounded division by the product of all dropped
    primes (ops/rnsops.MultiDropPlan) when two or more levels are dropped:
    decrypts equal to the per-level chain, not bit-identical to it (compare
    it with the JAX package's fused_drop=True step).  fused_drop=False
    chains the exact per-level divide_and_round_q_last.
    """
    context.check_device(device)
    first_id = context.first_parms_id
    if target_parms_id is None:
        target_parms_id = context.last_parms_id
    first_cd = context.get_context_data(first_id)
    target_cd = context.get_context_data(target_parms_id)
    levels = first_cd.chain_index - target_cd.chain_index
    mul = build_bfv_mul_relin(context, first_id, square=square, device=device)

    if fused_drop and levels >= 2:
        plan = MultiDropPlan(context, first_id, levels)

        def drop(y):
            return divide_and_round_multi(y, plan)
    else:
        tools = []
        cd = first_cd
        for _ in range(levels):
            tools.append(cd.device_rns_tool)
            cd = cd.next_context_data

        def drop(y):
            for tool in tools:
                y = divide_and_round_q_last(y, tool)
            return y

    if square:
        return lambda a, relin_key: drop(mul(a, relin_key))
    return lambda a, b, relin_key: drop(mul(a, b, relin_key))
