"""Evaluation pipelines over raw ciphertext tensors.

Port of these steps of gemini_seal_tpu/models/pipelines.py: CKKS multiply
+ relinearize + rescale (sequential and fused forms), rotate, the hoisted
multi-rotation step in both key forms (plain and counter-rotated keys), the
flagship train step (multiply + relinearize + rescale, rotate, add), the
deep polynomial evaluation and the encrypted matrix-vector products (the
hoisted diagonal method and baby-step/giant-step); the BFV (BEHZ) multiply
+ relinearize, its mod-switch chain and the hoisted row rotations.  Every step takes
ciphertext data shaped [..., size, L, N] with any leading batch axes, as
the JAX functions do.
PyTorch runs eagerly; each modular-arithmetic stage is one launch of a
hand-written kernel (``tensor_product``, ``ntt``, ``contract``,
``elementwise``, ``galois``, ``behz``) on the context's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..context import SealContext
from ..ops import cuda
from ..ops.backend import is_cuda
from ..ops.dyadic import LimbConstants, add_poly, dyadic_product, multiply_poly_scalar
from ..ops.galois import galois_permute
from ..ops.keyswitch import (KeySwitchPlan, batched_rotated_inner_product,
                             compute_modup_digits, fused_moddown, keys_stack_inner_product,
                             keyswitch_inner_product, rescale_special, switch_key)
from ..ops.modops import add_mod, contract_mulmod_128, mul_mod
from ..ops.ntt import ntt_forward_lazy, ntt_inverse
from ..ops.rnsops import (MultiDropPlan, divide_and_round_multi, divide_and_round_q_last,
                          divide_and_round_q_last_ntt, fast_floor, fastbconv_m_tilde,
                          fastbconv_sk, sm_mrq)

__all__ = ["build_ckks_mul_relin_rescale", "build_ckks_rotate",
           "build_ckks_rotate_many", "build_ckks_train_step", "build_ckks_poly_eval",
           "build_bfv_mul_relin", "build_bfv_mul_relin_modswitch", "build_bfv_rotate_many",
           "prepermute_galois_stack", "tensor_product_plain", "build_ckks_matvec",
           "build_ckks_matvec_bsgs"]


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


def prepermute_galois_stack(tool, elts, keys_stack):
    """Counter-rotate a stacked Galois key set by each element's inverse
    NTT permutation (build time; one paired ``galois`` launch).

    The automorphism pi is a pure coefficient permutation in the NTT
    domain, so sum_b pi(D_b(c1)) * k_b = pi(sum_b D_b(c1) * pi^-1(k_b)):
    with pi^-1 baked into the keys, the mod-up digits are contracted shared
    and unpermuted across every rotation, and one permutation of the
    finished output per rotation replaces the per-rotation digit gather.

    tool: a GaloisTool of the ring; keys_stack: int64[R, n_bundles, 2,
    L_key, N] in elts order.  Returns the counter-rotated stack, equal to
    the JAX package's prepermute_galois_stack.
    """
    R, N = keys_stack.shape[0], keys_stack.shape[-1]
    if R != len(elts):
        raise ValueError(f"{len(elts)} elements for {R} stacked keys")
    x = keys_stack.contiguous().reshape(R, -1, N)
    return galois_permute(x, tool.ntt_inverse_tables(elts), paired=True).reshape(
        keys_stack.shape)


def _shared_digit_inner_product(ct_k, keys_stack, plan: KeySwitchPlan):
    """Key-switch contraction with the rotation axis on the (counter-rotated)
    keys only: the digits are read in place for every rotation (``contract``
    in its broadcast mode), one launch per key component.

    ct_k: [..., nb, n_ext, N]; keys_stack: int64[R, nb, 2, L_key, N].
    Returns (a0, a1): [..., R, n_ext, N] reduced accumulators.
    """
    return keys_stack_inner_product(ct_k.contiguous().unsqueeze(-4), keys_stack, plan)


def _rotate_many(context, steps, parms_id, prepermuted_keys: bool, is_ntt: bool):
    """The hoisted multi-rotation step of both schemes: one mod-up of c1
    feeds every rotation's key switch.

    Default keys: the digits are permuted for every rotation and contracted
    (batched_rotated_inner_product), then c0 is permuted for every rotation
    in one launch.  Counter-rotated keys (prepermute_galois_stack): the
    digits are contracted shared and unpermuted, c0 is added to each
    rotation's result, and one paired launch takes each rotation's
    [2, L, N] output through its table.  CKKS (is_ntt) permutes in the NTT
    domain; BFV gathers in the power basis with the sign flip.
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    elts = tool.get_elts_from_steps(list(steps))
    plan = KeySwitchPlan(context, parms_id)
    rot_tabs = tool.ntt_tables(elts)
    out_tabs, out_mod = (rot_tabs, None) if is_ntt else (tool.coeff_tables(elts), limbs.p)

    def step(ct, keys_stack):
        c0 = ct[..., 0, :, :].contiguous()
        ct_k = compute_modup_digits(ct[..., 1, :, :], plan, is_ntt)    # hoisted
        if prepermuted_keys:
            a0, a1 = _shared_digit_inner_product(ct_k, keys_stack, plan)
        else:
            a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, keys_stack, plan)
        d0 = rescale_special(a0, plan, is_ntt_output=is_ntt)     # [..., R, L, N]
        d1 = rescale_special(a1, plan, is_ntt_output=is_ntt)
        if prepermuted_keys:
            x0 = add_poly(c0.unsqueeze(-3).expand(d0.shape).contiguous(), d0, limbs)
            x = torch.stack([x0, d1], dim=-3)                     # [..., R, 2, L, N]
            out = galois_permute(x.reshape(x.shape[:-3] + (-1, x.shape[-1])), out_tabs,
                                 out_mod, paired=True).reshape(x.shape)
        else:
            p0 = galois_permute(c0, out_tabs, out_mod)                # [..., R, L, N]
            out = torch.stack([add_poly(p0, d0, limbs), d1], dim=-3)
        return out.movedim(-4, 0)                                 # [R, ..., 2, L, N]

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

    prepermuted_keys=True: the stack must be counter-rotated with
    prepermute_galois_stack; the digits are contracted shared and
    unpermuted and one NTT-domain permutation of each finished output
    replaces the per-rotation digit gather.  Decrypts equal to the default
    form, not bit-identical to it (the special-prime mod-down's base
    conversion is not odd-symmetric); bit-identical to the JAX package's
    prepermuted form.
    """
    context.check_device(device)
    return _rotate_many(context, steps, parms_id, prepermuted_keys, is_ntt=True)


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


def build_bfv_rotate_many(context: SealContext, steps, parms_id=None,
                          prepermuted_keys: bool = False, device=None) -> Callable:
    """fn(ct, galois_keys_stack) -> [n_steps, ..., 2, L, N]: hoisted BFV row
    rotations (benchmark config 2's hoisted variant, 2'): one power-basis
    mod-up of c1 feeds every step's key-switch inner product, the
    special-prime mod-down returns to the power basis, and c0 takes every
    step's signed gather in one ``galois`` launch.

    ct: int64[..., 2, L, N] (power basis); galois_keys_stack:
    int64[n_steps, n_bundles, 2, L_key, N] in step order.
    prepermuted_keys=True: the stack must be counter-rotated with
    prepermute_galois_stack; the whole rotation is then one signed paired
    gather of each finished [2, L, N] output.  Decrypts equal to the
    default form, not bit-identical to it; bit-identical to the JAX
    package's prepermuted form.
    """
    context.check_device(device)
    return _rotate_many(context, steps, parms_id, prepermuted_keys, is_ntt=False)


def build_ckks_poly_eval(context: SealContext, coeffs, scale: float, encoder,
                         rotate_sum_log2: int = 0, coeff_precision_bits: int = 30,
                         fused: bool = False, composed: bool = False,
                         rotate_mode: str = "tree", parms_id=None, device=None):
    """Deep encrypted polynomial evaluation (BASELINE config 5).

    p(x) = sum_k coeffs[k] x^k over len(coeffs) - 2 multiplicative levels:
    a sequential power chain (multiply + relinearize + rescale, the first
    step the 3-product square), then the plaintext linear combination at
    the deepest level (each term's scalar encoded at the scale that aligns
    it to scale * 2^coeff_precision_bits), then optionally the sum of
    2^rotate_sum_log2 adjacent slots:

    - rotate_mode "tree": rotate_sum_log2 sequential rotations by 1, 2, 4,
      ... (apply_galois_ntt + switch_key), each added on;
    - "flat": one hoisted mod-up feeds 2^m - 1 inner products
      (batched_rotated_inner_product), whose reduced accumulators are
      summed and mod-downed once (rescale_special); keys for every step
      1 .. 2^m - 1 in step order.

    composed is accepted for the JAX signature: there it jits one program
    per level, a TPU compile workaround; here both values return the same
    eager chain, so their outputs are bit-identical.

    Returns (step, deep_parms_id, out_scale): step(x, relin_key,
    galois_keys_stack) -> int64[..., 2, L_deep, N], bit-identical to the
    JAX package's step of the same options.
    """
    context.check_device(device)
    degree = len(coeffs) - 1
    if degree < 2:
        raise ValueError("need a polynomial of degree >= 2")
    if rotate_mode not in ("tree", "flat"):
        raise ValueError(f"unknown rotate_mode {rotate_mode!r}")
    n_levels = degree - 1
    ids = [parms_id if parms_id is not None else context.first_parms_id]
    while len(ids) < n_levels + 1:
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short for this degree")
        ids.append(nxt.parms_id)
    deep_id = ids[n_levels]
    deep_cd = context.get_context_data(deep_id)
    deep_limbs = deep_cd.limb_constants
    L_deep = len(deep_cd.parms.coeff_modulus)
    level_L = [len(context.get_context_data(i).parms.coeff_modulus) for i in ids]

    muls = [build_ckks_mul_relin_rescale(context, ids[k], fused=fused, square=(k == 0),
                                         device=device)
            for k in range(n_levels)]

    # scale of x^k after the chain
    power_scales = [None, float(scale)]
    for k in range(n_levels):
        q_last = context.get_context_data(ids[k]).parms.coeff_modulus[-1].value
        power_scales.append(power_scales[-1] * scale / q_last)

    # plaintext multipliers aligned to one common output scale
    target_scale = float(scale) * (2.0 ** coeff_precision_bits)
    plains = [encoder.encode(coeffs[k], target_scale / power_scales[k], deep_id).data
              for k in range(1, degree + 1)]
    const_plain = encoder.encode(coeffs[0], target_scale, deep_id).data

    tool = deep_cd.galois_tool
    rot_plan = KeySwitchPlan(context, deep_id) if rotate_sum_log2 else None
    if rotate_sum_log2 and rotate_mode == "flat":
        flat_tabs = tool.ntt_tables(
            [tool.get_elt_from_step(s) for s in range(1, 1 << rotate_sum_log2)])
    tree_elts = [tool.get_elt_from_step(1 << i) for i in range(rotate_sum_log2)]

    def rotate_sum_flat(r, galois_keys_stack):
        ext = rot_plan.ext_limbs
        c0r, c1r = r[..., 0, :, :].contiguous(), r[..., 1, :, :]
        ct_k = compute_modup_digits(c1r, rot_plan, True)              # hoisted once
        a0, a1 = batched_rotated_inner_product(ct_k, flat_tabs, galois_keys_stack, rot_plan)
        R = flat_tabs.shape[0]
        # the reduced accumulators fold over R (one mod-down for all R)
        raw0, raw1 = a0[..., 0, :, :].contiguous(), a1[..., 0, :, :].contiguous()
        for i in range(1, R):
            raw0 = add_poly(raw0, a0[..., i, :, :].contiguous(), ext)
            raw1 = add_poly(raw1, a1[..., i, :, :].contiguous(), ext)
        c0_rot = galois_permute(c0r, flat_tabs)                        # [..., R, L, N]
        c0_acc = c0r
        for i in range(R):
            c0_acc = add_poly(c0_acc, c0_rot[..., i, :, :].contiguous(), deep_limbs)
        d0 = rescale_special(raw0, rot_plan, is_ntt_output=True)
        d1 = rescale_special(raw1, rot_plan, is_ntt_output=True)
        return torch.stack([add_poly(c0_acc, d0, deep_limbs),
                            add_poly(c1r.contiguous(), d1, deep_limbs)], dim=-3)

    def rotate_sum_tree(r, galois_keys_stack):
        for i, elt in enumerate(tree_elts):
            rc = tool.apply_galois_ntt(r, elt)                         # both components
            d0, d1 = switch_key(rc[..., 1, :, :], galois_keys_stack[i], rot_plan, True)
            rot = torch.stack([add_poly(rc[..., 0, :, :].contiguous(), d0, deep_limbs), d1],
                              dim=-3)
            r = add_poly(r, rot, deep_limbs)
        return r

    def step(x, relin_key, galois_keys_stack):
        # power chain: powers[k] = x^(k+1) at level k
        powers = [x]
        for k in range(n_levels):
            if k == 0:
                powers.append(muls[0](x, relin_key))
            else:
                powers.append(muls[k](powers[-1], x[..., :level_L[k], :], relin_key))
        # the plaintext linear combination at the deepest level
        acc = None
        for k in range(1, degree + 1):
            pk = powers[k - 1][..., :L_deep, :].contiguous()           # mod-switch drop
            term = dyadic_product(pk, plains[k - 1], deep_limbs)
            acc = term if acc is None else add_poly(acc, term, deep_limbs)
        c0 = add_poly(acc[..., 0, :, :].contiguous(), const_plain, deep_limbs)
        r = torch.cat([c0.unsqueeze(-3), acc[..., 1:, :, :]], dim=-3)
        if not rotate_sum_log2:
            return r
        if rotate_mode == "flat":
            return rotate_sum_flat(r, galois_keys_stack)
        return rotate_sum_tree(r, galois_keys_stack)

    return step, deep_id, target_scale


def _contract(a, w, limbs: LimbConstants):
    """out[..., g, j, n] = sum_k a[..., g|0, k, j, n] * w[g, k, j, n] mod
    p_j: one ``contract`` launch (K3), exact in 128 bits, then one Barrett.
    The matvecs' diagonal sums (accumulate_mulmod_128 over the rotation or
    baby axis in the JAX package) are such contractions with per-coefficient
    weights."""
    return contract_mulmod_128(a.contiguous(), w, limbs.p.reshape(-1),
                               limbs.ratio0.reshape(-1), limbs.ratio1.reshape(-1))


def _sum_rows(x, limbs: LimbConstants):
    """sum_k x[..., k, :, :] mod p: one unit-weight ``contract`` launch over
    the axis -3 of x [..., K, L, N] -> [..., L, N].  Equal to the JAX
    package's chain of add_poly over k: every partial sum is canonical and
    modular addition is exact."""
    K, L = x.shape[-3], x.shape[-2]
    ones = torch.ones((1, K, L, 1), dtype=torch.int64, device=x.device)
    return _contract(x.unsqueeze(-4), ones, limbs).squeeze(-3)


def build_ckks_matvec(context: SealContext, diagonals, scale: float, encoder,
                      parms_id=None, fuse_moddown: bool = True, device=None) -> Callable:
    """Encrypted matrix-vector product by the diagonal method with hoisted
    rotations: y = sum_d diag_d (*) rot(x, d), one key-switch mod-up feeding
    every rotation (the JAX package's build_ckks_matvec).

    diagonals: {step d: slot values} for the nonzero generalized diagonals
    M[i, (i+d) % cols]; step 0 needs no key.  Returns fn(ct,
    galois_keys_stack) -> int64[..., 2, L, N] at the same level with scale
    scale * scale; galois_keys_stack: int64[n_nonzero_steps, n_bundles, 2,
    L_key, N] in sorted step order.

    The rotated c0 rows are one ``galois`` launch that writes [..., R, L, N];
    every R-term diagonal sum is one ``contract`` launch with the diagonal
    encodings as per-coefficient weights.  fuse_moddown (default): the raw
    key-switch accumulators are multiplied by extended-base encodings
    (CKKSEncoder.encode_at_base) and summed, then mod-downed once; decrypts
    equal to fuse_moddown=False, not bit-identical to it, and bit-identical
    to the JAX package's step of the same form.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)

    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    # every diagonal encoded with one NTT launch per base
    encoded = encoder.encode_stack([list(diagonals[s]) for s in steps], scale, parms_id)
    plains = dict(zip(steps, encoded))
    R = len(rot_steps)
    if R:
        rot_tabs = tool.ntt_tables(elts)                                  # [R, N]
        ptc = torch.stack([plains[s] for s in rot_steps]).unsqueeze(0)    # [1, R, L, N]
        if fuse_moddown:
            pte = encoder.encode_stack([list(diagonals[s]) for s in rot_steps], scale,
                                       parms_id, plan.ext_moduli,
                                       plan.ext_tables).unsqueeze(0)      # [1, R, n_ext, N]

    def step(ct, galois_keys_stack):
        ct = ct.contiguous()
        c0 = ct[..., 0, :, :].contiguous()
        acc = dyadic_product(ct, plains[0], limbs) if 0 in plains else None
        if not R:
            return acc
        ct_k = compute_modup_digits(ct[..., 1, :, :], plan, True)        # hoisted once
        a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, galois_keys_stack, plan)
        rc = galois_permute(c0, rot_tabs)                                 # [..., R, L, N]
        if fuse_moddown:
            ext = plan.ext_limbs
            raw0 = _contract(a0.unsqueeze(-4), pte, ext).squeeze(-3)
            raw1 = _contract(a1.unsqueeze(-4), pte, ext).squeeze(-3)
            ct_part = _contract(rc.unsqueeze(-4), ptc, limbs).squeeze(-3)
            d0 = rescale_special(raw0, plan, is_ntt_output=True)
            d1 = rescale_special(raw1, plan, is_ntt_output=True)
            term = torch.stack([add_poly(ct_part, d0, limbs), d1], dim=-3)
        else:
            d0 = rescale_special(a0, plan, is_ntt_output=True)           # [..., R, L, N]
            d1 = rescale_special(a1, plan, is_ntt_output=True)
            x0 = add_poly(rc, d0, limbs)
            term = torch.stack([_contract(x0.unsqueeze(-4), ptc, limbs).squeeze(-3),
                                _contract(d1.unsqueeze(-4), ptc, limbs).squeeze(-3)], dim=-3)
        return term if acc is None else add_poly(acc, term, limbs)

    return step


def build_ckks_matvec_bsgs(context: SealContext, diagonals, scale: float, encoder,
                           parms_id=None, baby: int = None, device=None):
    """Baby-step/giant-step encrypted matvec (Halevi-Shoup; the JAX
    package's build_ckks_matvec_bsgs): k diagonals cost B-1 baby and G-1
    giant key switches, with diag_d (*) rot(x, d) = rot(rot(diag_d, -gB)
    (*) rot(x, b), gB) for d = gB + b, so y = sum_g rot_gB(S_g), S_g =
    sum_b diag'_{g,b} (*) rot_b(x).

    One hoisted mod-up feeds every baby rotation; each S_g (g >= 1) gets
    its own special-prime mod-down, is giant-rotated (one paired
    ``galois`` launch for all giants) and key-switched, and the giants'
    raw accumulators are summed with S_0's for one final mod-down.  The
    baby sums, the giant sums and the final sums are ``contract`` launches.
    Decrypts equal to the rotation-by-rotation path, bit-identical to the
    JAX package's step.

    diagonals: {step d: slot values} (negative steps normalize to slots +
    d); baby: B (default ceil(sqrt(#steps))).  Returns (fn, rot_steps):
    fn(ct, galois_keys_stack) -> int64[..., 2, L, N] at the same level with
    scale scale * scale; galois_keys_stack in `rot_steps` order (baby steps
    then giant steps).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)
    slots = cd.parms.poly_modulus_degree // 2
    dev = context.device

    norm = {}
    for s, v in diagonals.items():
        ns = int(s) % slots
        if ns in norm:
            raise ValueError("diagonal steps collide modulo the slot count")
        norm[ns] = v
    diagonals = norm
    steps = sorted(diagonals.keys())
    if baby is None:
        baby = max(1, int(np.ceil(np.sqrt(len(steps)))))
    B = int(baby)
    groups = {}                       # giant g -> {baby b: slot vector}
    for s in steps:
        g, b = divmod(s, B)
        groups.setdefault(g, {})[b] = np.asarray(list(diagonals[s]), dtype=np.complex128)
    giants = sorted(groups.keys())
    babies = sorted({b for gd in groups.values() for b in gd})
    baby_rot = [b for b in babies if b != 0]
    giant_rot = [g * B for g in giants if g != 0]
    rot_steps = baby_rot + giant_rot

    babies_idx = {b: i for i, b in enumerate(babies)}
    Bf, Br, G = len(babies), len(baby_rot), len(giants)
    has_g0 = giants[0] == 0
    n_ext, n_ct = plan.n_ext, plan.n_ct_rns
    N = cd.parms.poly_modulus_degree
    # the whole BSGS grid as dense stacks; absent (g, b) cells are zero
    # plaintexts, which add exact zeros to every modular contraction
    cells = [(gi, babies_idx[b], np.roll(vec, g * B)[:slots].tolist())   # rot(vec, -gB)
             for gi, g in enumerate(giants) for b, vec in groups[g].items()]
    gi_idx = torch.tensor([c[0] for c in cells], device=dev)
    bi_idx = torch.tensor([c[1] for c in cells], device=dev)
    vecs = [c[2] for c in cells]
    pt_ct = torch.zeros((G, Bf, n_ct, N), dtype=torch.int64, device=dev)
    pt_ext = torch.zeros((G, Bf, n_ext, N), dtype=torch.int64, device=dev)
    pt_ct[gi_idx, bi_idx] = encoder.encode_stack(vecs, scale, parms_id)
    pt_ext[gi_idx, bi_idx] = encoder.encode_stack(vecs, scale, parms_id, plan.ext_moduli,
                                                  plan.ext_tables)
    baby_tabs = tool.ntt_tables([tool.get_elt_from_step(b) for b in baby_rot]) if Br else None
    rot_gi = [gi for gi, g in enumerate(giants) if g != 0]
    giant_tabs = (tool.ntt_tables([tool.get_elt_from_step(giants[gi] * B) for gi in rot_gi])
                  if rot_gi else None)
    pte_rot = pt_ext[:, [babies_idx[b] for b in baby_rot]].contiguous() if Br else None
    pt_b0 = pt_ct[:, babies_idx[0]].unsqueeze(1).contiguous() if 0 in babies_idx else None

    def step(ct, galois_keys_stack):
        ct = ct.contiguous()
        c0 = ct[..., 0, :, :].contiguous()
        c1 = ct[..., 1, :, :].contiguous()
        ext = plan.ext_limbs
        rows = [c0.unsqueeze(-3)] if 0 in babies_idx else []
        if Br:
            ct_k = compute_modup_digits(c1, plan, True)                  # hoisted once
            a0, a1 = batched_rotated_inner_product(ct_k, baby_tabs, galois_keys_stack[:Br],
                                                   plan)                 # [..., Br, n_ext, N]
            rows.append(galois_permute(c0, baby_tabs))                   # [..., Br, L, N]
        # S_g for all giants: the baby axis contracted once per plane
        c0_rows = torch.cat(rows, dim=-3) if len(rows) > 1 else rows[0]
        s0_ct = _contract(c0_rows.unsqueeze(-4), pt_ct, limbs)           # [..., G, L, N]
        if pt_b0 is not None:
            s1_ct = _contract(c1.unsqueeze(-3).unsqueeze(-4), pt_b0, limbs)
        else:
            s1_ct = torch.zeros_like(s0_ct)
        if Br:
            s0_raw = _contract(a0.unsqueeze(-4), pte_rot, ext)             # [..., G, n_ext, N]
            s1_raw = _contract(a1.unsqueeze(-4), pte_rot, ext)

        fin0_ct = fin1_ct = fin0_raw = fin1_raw = None
        if has_g0:
            # S_0 folds straight into the final accumulators
            fin0_ct, fin1_ct = s0_ct[..., 0, :, :], s1_ct[..., 0, :, :]
            if Br:
                fin0_raw, fin1_raw = s0_raw[..., 0, :, :], s1_raw[..., 0, :, :]
        if rot_gi:
            # every rotated giant: one batched mod-down, one paired
            # permutation, one batched key switch over the giant axis
            gs = slice(1, None) if has_g0 else slice(None)
            sg = torch.stack([s0_ct[..., gs, :, :], s1_ct[..., gs, :, :]], dim=-3)
            if Br:
                raw = torch.stack([s0_raw[..., gs, :, :], s1_raw[..., gs, :, :]], dim=-3)
                sg = add_poly(sg, rescale_special(raw.contiguous(), plan,
                                                  is_ntt_output=True), limbs)
            rot = galois_permute(sg.reshape(sg.shape[:-3] + (2 * n_ct, N)), giant_tabs,
                                 paired=True).reshape(sg.shape)       # [..., Gr, 2, L, N]
            digits = compute_modup_digits(rot[..., 1, :, :], plan, True)
            ga0, ga1 = keys_stack_inner_product(digits, galois_keys_stack[Br:], plan)
            parts = [(rot[..., 0, :, :], fin0_ct, limbs), (ga0, fin0_raw, ext),
                     (ga1, fin1_raw, ext)]
            sums = []
            for x, first, lim in parts:
                tot = _sum_rows(x, lim)
                sums.append(tot if first is None else add_poly(first.contiguous(), tot, lim))
            fin0_ct, fin0_raw, fin1_raw = sums
        out0, out1 = fin0_ct, fin1_ct
        if fin0_raw is not None:
            d = rescale_special(torch.stack([fin0_raw, fin1_raw], dim=-3), plan,
                                is_ntt_output=True)
            d0, d1 = d[..., 0, :, :], d[..., 1, :, :]
            out0 = d0 if out0 is None else add_poly(out0.contiguous(), d0.contiguous(), limbs)
            out1 = d1 if out1 is None else add_poly(out1.contiguous(), d1.contiguous(), limbs)
        return torch.stack([out0, out1], dim=-3)

    return step, rot_steps
