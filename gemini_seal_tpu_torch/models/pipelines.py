"""Evaluation pipelines over raw ciphertext tensors.

Port of these steps of gemini_seal_tpu/models/pipelines.py: CKKS multiply
+ relinearize + rescale (sequential and fused forms), rotate, the hoisted
multi-rotation step in both key forms (plain and counter-rotated keys), the
flagship train step (multiply + relinearize + rescale, rotate, add), the
deep polynomial evaluation and the encrypted matrix-vector products (the
hoisted diagonal method and baby-step/giant-step); the encrypted model zoo
built on them (the dense layer, the MLP, the single- and multi-channel
convolutions and the CNN, the logistic-regression head and its training
step, the Goldschmidt reciprocal), the comparison builders (the composite
sign, ReLU, max, the Newton inverse square root and square root), the
encrypted matrix product and encrypted attention; the BFV (BEHZ) multiply
+ relinearize, its mod-switch chain, the hoisted row rotations and the
hoisted BFV matvec.
Every step takes ciphertext data shaped [..., size, L, N] with any leading
batch axes, as the JAX functions do.
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
from ..ops.backend import is_cuda, to_numpy, to_tensor
from ..ops.dyadic import (LimbConstants, add_poly, dyadic_product, multiply_poly_scalar,
                          negate_poly, sub_poly)
from ..ops.galois import galois_permute
from ..ops.keyswitch import (KeySwitchPlan, batched_rotated_inner_product,
                             compute_modup_digits, fused_moddown, keys_stack_inner_product,
                             keyswitch_inner_product, rescale_special, switch_key)
from ..ops.modops import add_mod, contract_mulmod_128, mul_mod
from ..ops.ntt import ntt_forward, ntt_forward_lazy, ntt_inverse
from ..ops.rnsops import (MultiDropPlan, divide_and_round_multi, divide_and_round_q_last,
                          divide_and_round_q_last_ntt, fast_floor, fastbconv_m_tilde,
                          fastbconv_sk, sm_mrq)
from ..tracing import span

__all__ = ["build_ckks_mul_relin_rescale", "build_ckks_rotate",
           "build_ckks_rotate_many", "build_ckks_train_step", "build_ckks_poly_eval",
           "build_bfv_mul_relin", "build_bfv_mul_relin_modswitch", "build_bfv_rotate_many",
           "prepermute_galois_stack", "tensor_product_plain", "build_ckks_matvec",
           "build_ckks_matvec_bsgs", "build_ckks_dense_layer", "build_ckks_mlp",
           "build_ckks_conv2d", "strided_dense_diagonals", "build_ckks_conv2d_mc",
           "build_ckks_cnn", "build_bfv_matvec", "build_ckks_logreg",
           "build_ckks_logreg_train_step", "build_ckks_inverse", "build_ckks_rsqrt",
           "build_ckks_sqrt", "SIGN_F3", "SIGN_G3", "sign_composite_reference",
           "build_ckks_sign", "build_ckks_relu", "build_ckks_max", "build_ckks_matmul_square",
           "attention_plan", "build_ckks_attention"]


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


def _relinearize_batched(c0, c1, c2, key_data, plan: KeySwitchPlan, limbs: LimbConstants,
                         is_ntt: bool):
    """Fold the c2 component back onto (c0, c1) by the hybrid key switch
    (switch_key on [..., L, N], batch axes broadcast), then add."""
    d0, d1 = switch_key(c2, key_data, plan, is_ntt)
    return add_poly(c0.contiguous(), d0, limbs), add_poly(c1.contiguous(), d1, limbs)


def _plain_add_c0(x, pt, limbs: LimbConstants):
    """A plaintext pt [L, N] added onto component 0 of x [..., 2, L, N]."""
    return torch.stack([add_poly(x[..., 0, :, :].contiguous(), pt, limbs), x[..., 1, :, :]],
                       dim=-3)


def _plain_mul_rescale(x, pt, cd):
    """Both components of x times the plaintext pt (one ``elementwise``
    launch), then the rounded division by the level's last prime."""
    t = dyadic_product(x.contiguous(), pt, cd.limb_constants)
    return divide_and_round_q_last_ntt(t, cd.device_rns_tool, cd.ntt_tables)


def _rotate_by_key(x, tool, elt: int, key, plan: KeySwitchPlan, limbs: LimbConstants):
    """One NTT-domain rotation: both components in one ``galois`` launch,
    then c1 key-switched back to s."""
    rc = tool.apply_galois_ntt(x, elt)
    d0, d1 = switch_key(rc[..., 1, :, :], key, plan, True)
    return torch.stack([add_poly(rc[..., 0, :, :].contiguous(), d0, limbs), d1], dim=-3)


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

        @span("step.ckks_mul_relin_rescale")
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

        @span("step.ckks_mul_relin_rescale")
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
        return _rotate_by_key(ct, tool, elt, galois_key, plan, limbs)

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


@span("keyswitch.inner_product")
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

    @span("step.rotate_many")
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

    @span("behz.extend")
    def extend(ct):
        # lazy [0, 4p) lifts into the tensor product's full-range Barrett
        # products, as in the JAX function
        ct = ct.contiguous()
        bsk = sm_mrq(fastbconv_m_tilde(ct, tool), tool)
        return ntt_forward_lazy(ct, cd.ntt_tables), ntt_forward_lazy(bsk, bsk_tables)

    @span("behz.floor")
    def floor(dq, dbsk):
        tq = multiply_poly_scalar(ntt_inverse(dq, cd.ntt_tables), t_q, limbs)
        tbsk = multiply_poly_scalar(ntt_inverse(dbsk, bsk_tables), t_bsk, bsk_limbs)
        return fastbconv_sk(fast_floor(tq, tbsk, tool), tool)

    @span("step.bfv_mul_relin")
    def step(a, b, relin_key):
        aq, absk = extend(a)
        if b is None:
            dq = _tensor_product(aq, None, limbs)
            dbsk = _tensor_product(absk, None, bsk_limbs)
        else:
            bq, bbsk = extend(b)
            dq = _tensor_product(aq, bq, limbs)
            dbsk = _tensor_product(absk, bbsk, bsk_limbs)
        c0, c1, c2 = floor(dq, dbsk)
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
            r = add_poly(r, _rotate_by_key(r, tool, elt, galois_keys_stack[i], rot_plan,
                                           deep_limbs), deep_limbs)
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
        r = _plain_add_c0(acc, const_plain, deep_limbs)
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


def build_ckks_dense_layer(context: SealContext, diagonals, bias, scale: float, encoder,
                           parms_id=None, activation: str = "square", bsgs: bool = False,
                           device=None):
    """One encrypted dense layer y = act(M x + b) (the JAX package's
    build_ckks_dense_layer, examples/ex9's flow in one step): the hoisted
    matvec with its raw accumulators mod-downed once (build_ckks_matvec,
    fuse_moddown; or build_ckks_matvec_bsgs with bsgs=True), the rescale by
    the level's last prime, the plaintext bias, and for activation "square"
    the 3-product square, relinearize and rescale.

    diagonals: {step: slot values} of M; bias: slot values of b;
    activation: "square" or None.  Returns (fn, out_parms_id, out_scale):
    fn(ct, galois_keys_stack, relin_key) -> int64[..., 2, L_out, N] in NTT
    form at out_scale, bit-identical to the JAX package's step; fn.rot_steps
    lists the rotation-key steps in stack order (both paths).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    cd1 = cd0.next_context_data
    if cd1 is None or (activation == "square" and cd1.next_context_data is None):
        raise ValueError("modulus chain too short for a dense layer")
    if bsgs:
        mv_step, rot_steps = build_ckks_matvec_bsgs(context, diagonals, scale, encoder,
                                                    parms_id, device=device)
    else:
        mv_step = build_ckks_matvec(context, diagonals, scale, encoder, parms_id,
                                    device=device)
        rot_steps = [s for s in sorted(diagonals) if s != 0]
    q0 = cd0.parms.coeff_modulus[-1].value
    scale_r = scale * scale / q0
    limbs1 = cd1.limb_constants
    bias_pt = encoder.encode(list(bias), scale_r, cd1.parms_id).data
    if activation == "square":
        plan1 = KeySwitchPlan(context, cd1.parms_id)
        out_parms_id = cd1.next_context_data.parms_id
        out_scale = scale_r * scale_r / cd1.parms.coeff_modulus[-1].value
    elif activation is None:
        out_parms_id = cd1.parms_id
        out_scale = scale_r
    else:
        raise ValueError(f"unsupported activation {activation!r}")
    tool0, tables0 = cd0.device_rns_tool, cd0.ntt_tables

    def step(ct, galois_keys_stack, relin_key):
        y = mv_step(ct, galois_keys_stack)                          # [..., 2, L0, N] scale^2
        y = _plain_add_c0(divide_and_round_q_last_ntt(y, tool0, tables0), bias_pt, limbs1)
        if activation == "square":
            d0, d1, d2 = _tensor_product(y.contiguous(), None, limbs1)
            y = torch.stack(_relinearize_batched(d0, d1, d2, relin_key, plan1, limbs1, True),
                            dim=-3)
            y = divide_and_round_q_last_ntt(y, cd1.device_rns_tool, cd1.ntt_tables)
        return y

    step.rot_steps = rot_steps
    return step, out_parms_id, out_scale


def _chain(fns):
    """fn(ct, [galois_keys_stack per layer], relin_key): the layers in turn."""
    def step(ct, gk_stacks, relin_key):
        y = ct
        for fn, g in zip(fns, gk_stacks):
            y = fn(y, g, relin_key)
        return y

    return step


def build_ckks_mlp(context: SealContext, layers, scale: float, encoder, bsgs: bool = False,
                   device=None):
    """A chain of build_ckks_dense_layer steps down the modulus chain (each
    linear layer one level, each squared layer two), the JAX package's
    build_ckks_mlp.

    layers: [(diagonals, bias, activation), ...].  Returns (fn,
    out_parms_id, out_scale): fn(ct, [galois_keys_stack per layer],
    relin_key) -> int64[..., 2, L_out, N]; fn.rot_steps: one list per layer.
    """
    context.check_device(device)
    fns = []
    pid = context.first_parms_id
    cur_scale = float(scale)
    for diagonals, bias, act in layers:
        fn, pid, cur_scale = build_ckks_dense_layer(context, diagonals, bias, cur_scale,
                                                    encoder, parms_id=pid, activation=act,
                                                    bsgs=bsgs, device=device)
        fns.append(fn)
    step = _chain(fns)
    step.rot_steps = [fn.rot_steps for fn in fns]
    return step, pid, cur_scale


def _tap_mask(dy: int, dx: int, height: int, width: int, weight: float) -> np.ndarray:
    """weight where the source pixel (r + dy, c + dx) lies in the image, 0
    elsewhere, row-major over the h*w image: SAME zero padding."""
    rr, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    valid = (rr + dy >= 0) & (rr + dy < height) & (cc + dx >= 0) & (cc + dx < width)
    return np.where(valid, weight, 0.0).reshape(-1)


def build_ckks_conv2d(context: SealContext, kernel, height: int, width: int, scale: float,
                      encoder, bias=None, parms_id=None, activation: str = None,
                      periodic: bool = False, device=None):
    """Encrypted single-channel SAME 2-D convolution (+ bias + optional
    square) over a row-major image in the slots, the JAX package's
    build_ckks_conv2d: tap (dy, dx) is the generalized diagonal of step
    dy*width + dx holding the tap's weight masked to zero where the source
    pixel falls outside the image, so the layer is one dense layer
    (build_ckks_dense_layer, hoisted matvec).  periodic=True tiles the
    masks over the whole slot vector (slots % (h*w) == 0), for chaining.

    Returns (fn, out_parms_id, out_scale, rot_steps): fn(ct,
    galois_keys_stack, relin_key) with Galois keys for rot_steps in order.
    """
    context.check_device(device)
    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        raise ValueError("kernel must be 2-D with odd dimensions")
    kh, kw = k.shape
    if parms_id is None:
        parms_id = context.first_parms_id
    slots = context.get_context_data(parms_id).parms.poly_modulus_degree // 2
    if height * width > slots:
        raise ValueError("image does not fit in the slot count")
    if abs(kw // 2) >= width or abs(kh // 2) >= height:
        raise ValueError("kernel larger than the image")
    if periodic and slots % (height * width) != 0:
        raise ValueError("periodic conv needs slot_count % (h*w) == 0")
    diagonals = {}
    for dy in range(-(kh // 2), kh // 2 + 1):
        for dx in range(-(kw // 2), kw // 2 + 1):
            wt = float(k[dy + kh // 2, dx + kw // 2])
            if wt == 0.0:
                continue
            mask = _tap_mask(dy, dx, height, width, wt)
            if periodic:
                mask = np.tile(mask, slots // (height * width))
            diagonals[dy * width + dx] = mask.tolist()
    if bias is None:
        bias = [0.0] * (height * width)
    fn, out_pid, out_scale = build_ckks_dense_layer(context, diagonals, bias, scale, encoder,
                                                    parms_id=parms_id, activation=activation,
                                                    device=device)
    return fn, out_pid, out_scale, fn.rot_steps


def strided_dense_diagonals(M, height: int, width: int, stride: int, slots: int):
    """Generalized diagonals of the slot-linear map that reads the
    stride-subsampled grid of an h*w image and writes n_out compact outputs
    at slots [0, n_out) (striding absorbed into the next dense layer), the
    JAX package's strided_dense_diagonals.

    M: [n_out, ph*pw] over the pooled pixels (ph = ceil(h/stride)).
    Returns {step: slot values} with steps in [0, slots), for
    build_ckks_dense_layer(bsgs=True).
    """
    M = np.asarray(M, dtype=np.float64)
    ph = (height + stride - 1) // stride
    pw = (width + stride - 1) // stride
    if M.shape[1] != ph * pw:
        raise ValueError("M columns must equal the pooled pixel count")
    n_out = M.shape[0]
    if n_out > slots or height * width > slots:
        raise ValueError("map does not fit in the slot count")
    src = [(r * stride) * width + c * stride for r in range(ph) for c in range(pw)]
    diagonals = {}
    for j in range(n_out):
        for jp in range(ph * pw):
            wt = float(M[j, jp])
            if wt == 0.0:
                continue
            m = diagonals.setdefault((src[jp] - j) % slots, np.zeros(slots))
            m[j] += wt
    return {s: m.tolist() for s, m in diagonals.items()}


def build_ckks_conv2d_mc(context: SealContext, kernel, height: int, width: int,
                         scale: float, encoder, bias=None, parms_id=None,
                         activation: str = None, periodic: bool = False, device=None):
    """Multi-channel encrypted 2-D convolution, kernel [oc, ic, kh, kw] over
    a channels-blocked packing (slot ch*h*w + r*w + c holds pixel (r, c) of
    channel ch), the JAX package's build_ckks_conv2d_mc: each (oc, ic, tap)
    adds its masked weight to the diagonal of step (ic - oc)*h*w + dy*w +
    dx, and the whole layer is one dense layer.  periodic=True tiles the
    masks with period oc*h*w (slots % (oc*h*w) == 0 and oc % ic == 0).

    Returns (fn, out_parms_id, out_scale, rot_steps).
    """
    context.check_device(device)
    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 4 or k.shape[2] % 2 == 0 or k.shape[3] % 2 == 0:
        raise ValueError("kernel must be [oc, ic, kh, kw] with odd kh/kw")
    OC, IC, kh, kw = k.shape
    if parms_id is None:
        parms_id = context.first_parms_id
    slots = context.get_context_data(parms_id).parms.poly_modulus_degree // 2
    hw = height * width
    if max(OC, IC) * hw > slots:
        raise ValueError("channel blocks do not fit in the slot count")
    if kh // 2 >= height or kw // 2 >= width:
        raise ValueError("kernel larger than the image")
    if periodic:
        if slots % (OC * hw) != 0:
            raise ValueError("periodic conv needs slots % (oc*h*w) == 0")
        if OC % IC != 0:
            raise ValueError("periodic chaining needs oc % ic == 0")
    out_len = OC * hw
    masks = {}
    for oc in range(OC):
        for ic in range(IC):
            for dy in range(-(kh // 2), kh // 2 + 1):
                for dx in range(-(kw // 2), kw // 2 + 1):
                    wt = float(k[oc, ic, dy + kh // 2, dx + kw // 2])
                    if wt == 0.0:
                        continue
                    m = masks.setdefault((ic - oc) * hw + dy * width + dx, np.zeros(out_len))
                    m[oc * hw:(oc + 1) * hw] += _tap_mask(dy, dx, height, width, wt)
    diagonals = {s: (np.tile(m, slots // out_len) if periodic else m).tolist()
                 for s, m in masks.items()}
    if bias is None:
        bias = [0.0] * out_len
    fn, out_pid, out_scale = build_ckks_dense_layer(context, diagonals, list(bias), scale,
                                                    encoder, parms_id=parms_id,
                                                    activation=activation, device=device)
    return fn, out_pid, out_scale, fn.rot_steps


def build_ckks_cnn(context: SealContext, convs, dense, height: int, width: int, scale: float,
                   encoder, bsgs: bool = True, device=None):
    """Encrypted CNN inference, the JAX package's build_ckks_cnn: periodic
    SAME convolutions (build_ckks_conv2d for a [kh, kw] kernel,
    build_ckks_conv2d_mc for [oc, ic, kh, kw]) then dense layers (on the
    baby-step/giant-step matvec with bsgs=True) down the modulus chain.
    The image is packed block-periodically (slot i holds pixel i mod h*w).

    convs: [(kernel, bias or None, activation), ...]; dense: [(diagonals,
    bias, activation), ...].  Returns (fn, out_parms_id, out_scale):
    fn(ct, [galois_keys_stack per layer], relin_key); fn.rot_steps: one
    list per layer, convolutions first.
    """
    context.check_device(device)
    fns, steps_all = [], []
    pid = context.first_parms_id
    cur = float(scale)
    for kernel, bias, act in convs:
        builder = build_ckks_conv2d_mc if np.asarray(kernel).ndim == 4 else build_ckks_conv2d
        fn, pid, cur, rsteps = builder(context, kernel, height, width, cur, encoder, bias=bias,
                                       parms_id=pid, activation=act, periodic=True,
                                       device=device)
        fns.append(fn)
        steps_all.append(rsteps)
    for diagonals, bias, act in dense:
        fn, pid, cur = build_ckks_dense_layer(context, diagonals, bias, cur, encoder,
                                              parms_id=pid, activation=act, bsgs=bsgs,
                                              device=device)
        fns.append(fn)
        steps_all.append(fn.rot_steps)
    step = _chain(fns)
    step.rot_steps = steps_all
    return step, pid, cur


def _centered_lift(plain, thresh: int, t: int, moduli, n: int) -> np.ndarray:
    """Residues over `moduli` (ints) of a BFV plaintext's coefficients
    lifted to signed values (v - t where v >= thresh): valid beyond the
    ciphertext base (evaluator.cpp:1560-1580 on the signed value)."""
    pdata = np.zeros(n, dtype=np.int64)
    arr = to_numpy(plain).astype(np.int64)
    pdata[: arr.shape[0]] = arr
    w = np.where(pdata >= np.int64(thresh), pdata - np.int64(t), pdata)
    return np.stack([np.mod(w, np.int64(m)).astype(np.uint64) for m in moduli])


def build_bfv_matvec(context: SealContext, diagonals, batch_encoder, parms_id=None,
                     device=None) -> Callable:
    """Encrypted BFV matrix-vector product by the diagonal method with
    hoisted rotations and one mod-down (the JAX package's build_bfv_matvec):
    y = sum_d diag_d (*) rot_rows(x, d).  One power-basis mod-up of c1 feeds
    every rotation's raw key-switch inner product; the raws are weighted by
    the diagonals' centred lifts in the NTT domain of the extended base and
    summed (one ``contract`` launch a component), then mod-downed once; the
    rotated c0 rows (one ``galois`` launch on one forward NTT of c0) are
    weighted by the lifts at the ciphertext base and summed.

    diagonals: {step d: slot values in [0, t)}.  Returns fn(ct,
    galois_keys_stack) -> int64[..., 2, L, N] in the power basis at the same
    level, bit-identical to the JAX package's step; galois_keys_stack:
    int64[n_nonzero_steps, n_bundles, 2, L_key, N] in sorted step order.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    tables = cd.ntt_tables
    plan = KeySwitchPlan(context, parms_id)
    thresh = cd.plain_upper_half_threshold
    t = cd.parms.plain_modulus.value
    n = cd.parms.poly_modulus_degree
    dev = context.device

    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    R = len(rot_steps)
    plains = batch_encoder.encode_batch([list(diagonals[s]) for s in steps])
    ct_mods = [m.value for m in cd.parms.coeff_modulus]

    def lifted(moduli, ntt_tables, which):
        rows = [_centered_lift(plains[steps.index(s)].data, thresh, t, moduli, n)
                for s in which]
        return ntt_forward(to_tensor(np.stack(rows), dev), ntt_tables)   # canonical

    plain0 = lifted(ct_mods, tables, [0])[0] if 0 in diagonals else None
    if R:
        rot_tabs = tool.ntt_tables([tool.get_elt_from_step(s) for s in rot_steps])
        ptc = lifted(ct_mods, tables, rot_steps).unsqueeze(0)               # [1, R, L, N]
        pte = lifted(plan.ext_moduli, plan.ext_tables, rot_steps).unsqueeze(0)

    def step(ct, galois_keys_stack):
        ct = ct.contiguous()
        if plain0 is not None:
            ct_ntt = ntt_forward(ct, tables)                               # both components
            acc = dyadic_product(ct_ntt, plain0, limbs)
            c0_ntt, acc0, acc1 = ct_ntt[..., 0, :, :], acc[..., 0, :, :], acc[..., 1, :, :]
        else:
            c0_ntt = ntt_forward(ct[..., 0, :, :].contiguous(), tables)
            acc0 = acc1 = None
        if R:
            ct_k = compute_modup_digits(ct[..., 1, :, :], plan, False)     # hoisted once
            a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, galois_keys_stack, plan)
            ext = plan.ext_limbs
            raw = torch.stack([_contract(a.unsqueeze(-4), pte, ext).squeeze(-3)
                               for a in (a0, a1)], dim=-3)                  # [..., 2, n_ext, N]
            rc = galois_permute(c0_ntt.contiguous(), rot_tabs)              # [..., R, L, N]
            p0 = _contract(rc.unsqueeze(-4), ptc, limbs).squeeze(-3)
            acc0 = p0 if acc0 is None else add_poly(acc0.contiguous(), p0, limbs)
            d = rescale_special(raw, plan, is_ntt_output=True)
            acc0 = add_poly(acc0, d[..., 0, :, :].contiguous(), limbs)
            d1 = d[..., 1, :, :]
            acc1 = d1 if acc1 is None else add_poly(acc1.contiguous(), d1.contiguous(), limbs)
        return ntt_inverse(torch.stack([acc0, acc1], dim=-3), tables)

    return step


def build_ckks_logreg(context: SealContext, weights, intercept: float, scale: float, encoder,
                      parms_id=None, device=None):
    """Encrypted logistic-regression inference p = sigma(w . x + b) with the
    degree-3 sigmoid 0.5 + 0.197 z - 0.004 z^3 (the JAX package's
    build_ckks_logreg), over four levels: the plaintext product w (*) x and
    rescale, a log2 rotation tree summing the feature slots, + b, the
    square z^2 (multiply + relinearize + rescale), u = a3 z^2 + a1
    (plaintext product at the prime q[2] as its scale, rescale), z * u
    (multiply + relinearize + rescale), + 0.5.

    weights: F feature weights.  Returns (fn, out_parms_id, out_scale,
    rot_steps): fn(x, galois_keys_stack, relin_key) -> int64[..., 2, L-4,
    N], slot 0 decrypting to sigma(w . x + b); Galois keys for the
    power-of-two rot_steps, in that order.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    F = len(list(weights))
    m = max(1, int(np.ceil(np.log2(max(F, 2)))))
    slots = cd0.parms.poly_modulus_degree // 2
    if (1 << m) > slots:
        raise ValueError("feature count does not fit in the slot count")
    cds = [cd0]
    for _ in range(4):
        nxt = cds[-1].next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short for logreg (needs 5)")
        cds.append(nxt)
    cd1, cd2, cd3, cd4 = cds[1:]
    q = [c.parms.coeff_modulus[-1].value for c in cds[:4]]

    w_full = np.zeros(slots, dtype=np.float64)
    w_full[:F] = np.asarray(list(weights), dtype=np.float64)
    w_pt = encoder.encode(w_full.tolist(), scale, parms_id).data
    s1 = float(scale) * float(scale) / q[0]            # z at cd1
    b_pt = encoder.encode(float(intercept), s1, cd1.parms_id).data
    s2 = s1 * s1 / q[1]                                # z^2 at cd2
    A1, A3 = 0.197, -0.004
    a3_pt = encoder.encode(A3, float(q[2]), cd2.parms_id).data
    su = s2 * float(q[2]) / q[2]                       # u at cd3
    a1_pt = encoder.encode(A1, su, cd3.parms_id).data
    out_scale = s1 * su / q[3]
    half_pt = encoder.encode(0.5, out_scale, cd4.parms_id).data

    limbs1 = cd1.limb_constants
    L3 = len(cd3.parms.coeff_modulus)
    plan1 = KeySwitchPlan(context, cd1.parms_id)
    tool1 = cd1.galois_tool
    rot_steps = [1 << i for i in range(m)]
    elts = [tool1.get_elt_from_step(s) for s in rot_steps]
    tool1.ntt_tables(elts)
    sq = build_ckks_mul_relin_rescale(context, cd1.parms_id, square=True, device=device)
    mul3 = build_ckks_mul_relin_rescale(context, cd3.parms_id, device=device)

    def step(x, galois_keys_stack, relin_key):
        t = _plain_mul_rescale(x, w_pt, cd0)                        # w (*) x at cd1
        for i, elt in enumerate(elts):                              # slot-sum tree
            t = add_poly(t, _rotate_by_key(t, tool1, elt, galois_keys_stack[i], plan1, limbs1),
                         limbs1)
        z = _plain_add_c0(t, b_pt, limbs1)
        u = _plain_add_c0(_plain_mul_rescale(sq(z, relin_key), a3_pt, cd2), a1_pt,
                          cd3.limb_constants)
        y = mul3(z[..., :L3, :], u, relin_key)                      # z dropped to cd3
        return _plain_add_c0(y, half_pt, cd4.limb_constants)

    return step, cd4.parms_id, out_scale, rot_steps


def build_ckks_logreg_train_step(context: SealContext, m: int, F: int, labels, alpha: float,
                                 scale: float, encoder, parms_id=None, device=None):
    """One encrypted gradient-descent iteration of logistic regression with
    X and w both encrypted (the JAX package's
    build_ckks_logreg_train_step): w' = w - alpha X^T (sigma3(X w) - y).

    Sample i fills slot block [i*Bf, (i+1)*Bf) (Bf the power of two >= F)
    with its features; w is replicated in every block.  Four ciphertext
    products and two masked rotation trees (in-block sums at levels 1 and 2,
    cross-block sums at levels 6 and 7) take seven levels; w' comes out
    replicated per block at the input scale.

    Returns (fn, out_parms_id, out_scale, rot_steps): fn(X, w,
    galois_keys_stack, relin_key) -> int64[..., 2, L-7, N], with Galois keys
    for the signed rot_steps, stacked in that order.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    slots = cd0.parms.poly_modulus_degree // 2
    b = max(1, int(np.ceil(np.log2(max(F, 2)))))
    Bf = 1 << b
    lm = max(1, int(np.ceil(np.log2(max(m, 2)))))
    if (1 << lm) * Bf > slots:
        raise ValueError("m x F packing does not fit in the slot count")
    labels = list(labels)
    if len(labels) != m:
        raise ValueError("labels must have m entries")
    cds = [cd0]
    for _ in range(7):
        nxt = cds[-1].next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short (needs 8 levels)")
        cds.append(nxt)
    q = [c.parms.coeff_modulus[-1].value for c in cds[:7]]
    L = [len(c.parms.coeff_modulus) for c in cds]
    limbs = [c.limb_constants for c in cds]
    tools = {i: cds[i].galois_tool for i in (1, 2, 6, 7)}
    plans = {i: KeySwitchPlan(context, cds[i].parms_id) for i in (1, 2, 6, 7)}

    # the scale ladder: the output lands at the input scale
    sc = float(scale)
    s1 = sc * sc / q[0]                      # u = X (*) w at L1
    sz2 = s1 * s1 / q[2]                     # z^2 at L3
    sv = s1 * sz2 / q[4]                     # v = z (c3 z^2 + c1) at L5
    sp = sv * sc / q[5]                      # p = d (*) X at L6
    alpha_scale = q[6] * sc / sp             # alpha g lands at sc
    A1, A3 = 0.197, -0.004
    mask1 = np.zeros(slots)
    mask1[::Bf] = 1.0
    mask1_pt = encoder.encode(mask1.tolist(), float(q[1]), cds[1].parms_id).data
    c3_pt = encoder.encode(A3, float(q[3]), cds[3].parms_id).data
    c1_pt = encoder.encode(A1, sz2, cds[4].parms_id).data
    c0y = np.zeros(slots)                    # 0.5 - y per block, 0 past m
    for i in range(min(m, slots // Bf)):
        c0y[i * Bf:(i + 1) * Bf] = 0.5 - labels[i]
    c0y_pt = encoder.encode(c0y.tolist(), sv, cds[5].parms_id).data
    mask2 = np.zeros(slots)
    mask2[:Bf] = float(alpha)
    mask2_pt = encoder.encode(mask2.tolist(), alpha_scale, cds[6].parms_id).data

    mul0 = build_ckks_mul_relin_rescale(context, cds[0].parms_id, device=device)
    sq2 = build_ckks_mul_relin_rescale(context, cds[2].parms_id, square=True, device=device)
    mul4 = build_ckks_mul_relin_rescale(context, cds[4].parms_id, device=device)
    mul5 = build_ckks_mul_relin_rescale(context, cds[5].parms_id, device=device)

    tree_steps = [1 << j for j in range(b)]
    spread_steps = [-(1 << j) for j in range(b)]
    xtree_steps = [Bf << j for j in range(lm)]
    xspread_steps = [-(Bf << j) for j in range(lm)]
    rot_steps = tree_steps + spread_steps + xtree_steps + xspread_steps
    key_idx = {s: i for i, s in enumerate(rot_steps)}
    elt_of = {}
    for lvl, ss in ((1, tree_steps), (2, spread_steps), (6, xtree_steps), (7, xspread_steps)):
        for s in ss:
            elt_of[lvl, s] = tools[lvl].get_elt_from_step(s)
        tools[lvl].ntt_tables([elt_of[lvl, s] for s in ss])

    def tree(x, ss, lvl, keys):
        for s in ss:
            x = add_poly(x, _rotate_by_key(x, tools[lvl], elt_of[lvl, s], keys[key_idx[s]],
                                           plans[lvl], limbs[lvl]), limbs[lvl])
        return x

    def step(X, w, galois_keys_stack, relin_key):
        gk = galois_keys_stack
        u = tree(mul0(X, w, relin_key), tree_steps, 1, gk)            # in-block sum, L1
        z = tree(_plain_mul_rescale(u, mask1_pt, cds[1]), spread_steps, 2, gk)  # L2, s1
        z2 = sq2(z, relin_key)                                         # L3, sz2
        up = _plain_add_c0(_plain_mul_rescale(z2, c3_pt, cds[3]), c1_pt, limbs[4])
        v = mul4(z[..., :L[4], :], up, relin_key)                      # L5, sv
        d = _plain_add_c0(v, c0y_pt, limbs[5])                         # sigma(z) - y
        p = tree(mul5(d, X[..., :L[5], :], relin_key), xtree_steps, 6, gk)  # cross-block
        ga = tree(_plain_mul_rescale(p, mask2_pt, cds[6]), xspread_steps, 7, gk)  # L7
        return sub_poly(w[..., :L[7], :].contiguous(), ga, limbs[7])

    return step, cds[7].parms_id, sc, rot_steps


def _level_ids(context: SealContext, parms_id, n_levels: int, what: str):
    """parms_id and the n_levels parms ids below it on the modulus chain."""
    ids = [parms_id]
    for _ in range(n_levels):
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError(f"modulus chain too short: {what} needs {n_levels} levels")
        ids.append(nxt.parms_id)
    return ids


def build_ckks_inverse(context: SealContext, scale: float, encoder, iters: int = 4,
                       parms_id=None, device=None):
    """Encrypted reciprocal 1/a by Goldschmidt iteration (the JAX package's
    build_ckks_inverse): x_0 = 2 - a, e_0 = 1 - a, e_{k+1} = e_k^2,
    x_{k+1} = x_k (1 + e_{k+1}), so a x_m = 1 - e_0^(2^(iters+1)) for slot
    values a in (0, 2).  The e-square chain runs one level ahead of the
    x-multiply chain, iters + 1 levels in all.

    Returns (fn, out_parms_id, out_scale): fn(ct_a, relin_key) with ct_a at
    `scale`.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    if iters < 1:
        raise ValueError("need at least one iteration")
    ids = _level_ids(context, parms_id, iters + 1, "inverse")
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]
    sqs = [build_ckks_mul_relin_rescale(context, ids[k], square=True, device=device)
           for k in range(iters)]            # e_k -> e_{k+1} at level k
    muls = [build_ckks_mul_relin_rescale(context, ids[k + 1], device=device)
            for k in range(iters)]           # x_k -> x_{k+1} at level k+1
    sig_e = [float(scale)]
    for k in range(iters):
        sig_e.append(sig_e[k] * sig_e[k] / q[k])
    sig_x = [float(scale)]
    for k in range(iters):
        sig_x.append(sig_x[k] * sig_e[k + 1] / q[k + 1])
    two0 = encoder.encode(2.0, sig_x[0], ids[0]).data
    one0 = encoder.encode(1.0, sig_e[0], ids[0]).data
    ones = [encoder.encode(1.0, sig_e[k + 1], ids[k + 1]).data for k in range(iters)]

    def step(ct_a, relin_key):
        neg = negate_poly(ct_a.contiguous(), limbs[0])           # -a, both components
        x = _plain_add_c0(neg, two0, limbs[0])                    # 1 + e_0, level 0
        e = _plain_add_c0(neg, one0, limbs[0])                    # e_0, level 0
        for k in range(iters):
            e = sqs[k](e, relin_key)                              # e_{k+1}, level k+1
            factor = _plain_add_c0(e, ones[k], limbs[k + 1])      # 1 + e_{k+1}
            x = muls[k](x[..., :Ls[k + 1], :], factor, relin_key)
        return x                                                  # level iters + 1

    return step, ids[iters + 1], sig_x[iters]


def build_ckks_rsqrt(context: SealContext, scale: float, encoder, iters: int = 3,
                     parms_id=None, device=None):
    """Encrypted inverse square root 1/sqrt(a) by Newton iteration (the JAX
    package's build_ckks_rsqrt): y_0 = 1, y_{k+1} = y_k (3 - a y_k^2) / 2
    for slot values a in (0, 2), four levels an iteration (y^2, a y^2,
    y (3 - a y^2) / 2, the closing rescale); the 3/2 and 1/2 constants
    encode at Dl^2 so the working scale stays stationary.

    Returns (fn, out_parms_id, out_scale): fn(ct_a, relin_key) with ct_a at
    `scale`.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    if iters < 1:
        raise ValueError("need at least one iteration")
    n_levels = 4 * iters
    ids = _level_ids(context, parms_id, n_levels, "rsqrt")
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]
    Dl = float(scale)

    def _enc(val, sc, lvl):
        return encoder.encode(float(val), sc, ids[lvl]).data

    stages = []
    sigma_y = Dl          # y_0 = 1 is re-encoded per build at input scale
    sigma_a = Dl
    for k in range(iters):
        b = 4 * k
        sq_y = build_ckks_mul_relin_rescale(context, ids[b], square=True, device=device)
        mul_u = build_ckks_mul_relin_rescale(context, ids[b + 1], device=device)
        mul_w = build_ckks_mul_relin_rescale(context, ids[b + 2], device=device)
        sigma_t = sigma_y * sigma_y / q[b]              # level b+1
        sigma_u = sigma_a * sigma_t / q[b + 1]          # level b+2
        sigma_v = Dl * Dl
        pt_half = _enc(0.5, sigma_v / sigma_u, b + 2)
        pt_3half = _enc(1.5, sigma_v, b + 2)
        sigma_w = sigma_y * sigma_v / q[b + 2]          # level b+3
        cd3 = cds[b + 3]
        sigma_y = sigma_w / q[b + 3]                    # level b+4

        def stage(y, ct_a, relin_key, b=b, sq_y=sq_y, mul_u=mul_u, mul_w=mul_w,
                  pt_half=pt_half, pt_3half=pt_3half, cd3=cd3):
            t = sq_y(y, relin_key)                                   # y^2, level b+1
            u = mul_u(ct_a[..., :Ls[b + 1], :], t, relin_key)        # a y^2, level b+2
            lim2 = limbs[b + 2]
            # (1.5 - u0/2, -u1/2): -(u/2) on both components, 3/2 onto c0
            v = _plain_add_c0(negate_poly(dyadic_product(u, pt_half, lim2), lim2),
                              pt_3half, lim2)
            w = mul_w(y[..., :Ls[b + 2], :], v, relin_key)
            return divide_and_round_q_last_ntt(w, cd3.device_rns_tool, cd3.ntt_tables)

        stages.append(stage)

    one0 = _enc(1.0, Dl, 0)

    def step(ct_a, relin_key):
        y = torch.zeros_like(ct_a)                 # y_0 = (one0, 0): transparent-free
        y[..., 0, :, :] = one0
        for stage in stages:
            y = stage(y, ct_a, relin_key)
        return y

    return step, ids[n_levels], sigma_y


def build_ckks_sqrt(context: SealContext, scale: float, encoder, iters: int = 3,
                    parms_id=None, device=None):
    """Encrypted sqrt(a) = a * rsqrt(a) for slot values in (0, 2) (the JAX
    package's build_ckks_sqrt): build_ckks_rsqrt plus one closing multiply
    with the limb-dropped input, 4 * iters + 1 levels.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    rs_fn, rs_pid, rs_scale = build_ckks_rsqrt(context, scale, encoder, iters=iters,
                                               parms_id=parms_id, device=device)
    rs_cd = context.get_context_data(rs_pid)
    out_cd = rs_cd.next_context_data
    if out_cd is None:
        raise ValueError("modulus chain too short: sqrt needs one more level after rsqrt")
    L_s = len(rs_cd.parms.coeff_modulus)
    mul_out = build_ckks_mul_relin_rescale(context, rs_pid, device=device)
    q_last = float(rs_cd.parms.coeff_modulus[-1].value)
    out_scale = rs_scale * float(scale) / q_last

    def step(ct_a, relin_key):
        y = rs_fn(ct_a, relin_key)
        return mul_out(ct_a[..., :L_s, :], y, relin_key)

    return step, out_cd.parms_id, out_scale


#: Odd degree-7 minimax component polynomials for composite sign
#: evaluation (Cheon-Kim-Kim, Asiacrypt'20): p(x) = x * q(x^2) with
#: q(y) = c0 + c1 y + c2 y^2 + c3 y^3.  f3 contracts toward +-1 on
#: [-1, 1] (f3(1) = 1); g3 widens the step first so fewer total
#: compositions reach a target resolution.
SIGN_F3 = (35 / 16, -35 / 16, 21 / 16, -5 / 16)
SIGN_G3 = (4589 / 1024, -16577 / 1024, 25614 / 1024, -12860 / 1024)


def sign_composite_reference(x, n_g: int = 1, n_f: int = 2):
    """Plain evaluation of the g3^(n_g) then f3^(n_f) composition — the
    exact curve the encrypted pipeline approximates (for tests/tuning)."""
    def _p(c, v):
        y = v * v
        return v * (c[0] + c[1] * y + c[2] * y * y + c[3] * y * y * y)

    v = np.asarray(x, dtype=np.float64)
    for _ in range(n_g):
        v = _p(SIGN_G3, v)
    for _ in range(n_f):
        v = _p(SIGN_F3, v)
    return v


def build_ckks_sign(context: SealContext, scale: float, encoder, n_g: int = 1, n_f: int = 2,
                    parms_id=None, device=None):
    """Encrypted sign(a) for slot values in [-1, 1] by the composite minimax
    schedule f3^(n_f) o g3^(n_g) (the JAX package's build_ckks_sign).

    Each odd degree-7 stage p(x) = hi(x) x^4 + lo(x), hi = c2 x + c3 x^3,
    lo = c0 x + c1 x^3, takes four levels (x^2, x^3 and x^4, hi x^4, the
    closing rescale); its coefficients encode at scales aligned per level
    as in the bootstrap's EvalMod, 4 * (n_g + n_f) levels in all.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    stages = [SIGN_G3] * n_g + [SIGN_F3] * n_f
    n_levels = 4 * len(stages)
    ids = _level_ids(context, parms_id, n_levels, "sign")
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]
    Dl = float(scale)

    def _enc(val, sc, lvl):
        return encoder.encode(float(val), sc, ids[lvl]).data

    def make_stage(b, coeffs, sigma_x):
        sq_x2 = build_ckks_mul_relin_rescale(context, ids[b], square=True, device=device)
        mul_x3 = build_ckks_mul_relin_rescale(context, ids[b + 1], device=device)
        sq_x4 = build_ckks_mul_relin_rescale(context, ids[b + 1], square=True, device=device)
        mul_w = build_ckks_mul_relin_rescale(context, ids[b + 2], device=device)
        c0, c1, c2, c3 = coeffs
        sigma_x2 = sigma_x * sigma_x / q[b]                 # level b+1
        sigma_x3 = sigma_x2 * sigma_x / q[b + 1]            # level b+2
        sigma_x4 = sigma_x2 * sigma_x2 / q[b + 1]           # level b+2
        sigma_hi = Dl * Dl
        pt_c2 = _enc(c2, sigma_hi / sigma_x, b + 2)
        pt_c3 = _enc(c3, sigma_hi / sigma_x3, b + 2)
        sigma_w = sigma_hi * sigma_x4 / q[b + 2]            # level b+3
        pt_c0 = _enc(c0, sigma_w / sigma_x, b + 3)
        pt_c1 = _enc(c1, sigma_w / sigma_x3, b + 3)
        sigma_out = sigma_w / q[b + 3]                      # level b+4
        lim2, lim3 = limbs[b + 2], limbs[b + 3]
        cd3 = cds[b + 3]

        def stage(x, relin_key):
            x2 = sq_x2(x, relin_key)                        # level b+1
            x3 = mul_x3(x2, x[..., :Ls[b + 1], :], relin_key)  # level b+2
            x4 = sq_x4(x2, relin_key)                       # level b+2
            hi = add_poly(dyadic_product(x[..., :Ls[b + 2], :].contiguous(), pt_c2, lim2),
                          dyadic_product(x3, pt_c3, lim2), lim2)
            w = mul_w(x4, hi, relin_key)                    # level b+3
            lo = add_poly(dyadic_product(x[..., :Ls[b + 3], :].contiguous(), pt_c0, lim3),
                          dyadic_product(x3[..., :Ls[b + 3], :].contiguous(), pt_c1, lim3),
                          lim3)
            return divide_and_round_q_last_ntt(add_poly(w, lo, lim3), cd3.device_rns_tool,
                                               cd3.ntt_tables)          # level b+4

        return stage, sigma_out

    fns = []
    sigma = Dl
    for i, coeffs in enumerate(stages):
        fn_i, sigma = make_stage(4 * i, coeffs, sigma)
        fns.append(fn_i)

    def step(ct_a, relin_key):
        x = ct_a
        for fn_i in fns:
            x = fn_i(x, relin_key)
        return x

    return step, ids[n_levels], sigma


def _sign_gate(context: SealContext, scale: float, encoder, n_g: int, n_f: int, parms_id,
               what: str, device):
    """The sign pipeline and the bookkeeping of the one multiply that
    follows it in relu and max: the ones-plaintext at the sign output's
    scale, the multiplier at the sign level and the halved output scale
    (the /2 of (1 +- sign) / 2 folds into out_scale)."""
    sign_fn, sign_pid, sign_scale = build_ckks_sign(context, scale, encoder, n_g=n_g,
                                                    n_f=n_f, parms_id=parms_id, device=device)
    sign_cd = context.get_context_data(sign_pid)
    out_cd = sign_cd.next_context_data
    if out_cd is None:
        raise ValueError(f"modulus chain too short: {what} needs one more level after sign")
    one_s = encoder.encode(1.0, sign_scale, sign_pid).data
    mul_out = build_ckks_mul_relin_rescale(context, sign_pid, device=device)
    q_last = float(sign_cd.parms.coeff_modulus[-1].value)
    out_scale = 2.0 * sign_scale * float(scale) / q_last
    return sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale


def build_ckks_relu(context: SealContext, scale: float, encoder, n_g: int = 1, n_f: int = 2,
                    parms_id=None, device=None):
    """Encrypted ReLU(a) = a (1 + sign(a)) / 2 for slot values in [-1, 1]
    (the JAX package's build_ckks_relu): the composite sign and one closing
    multiply with the limb-dropped input; the /2 folds into out_scale.
    4 * (n_g + n_f) + 1 levels.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale = _sign_gate(
        context, scale, encoder, n_g, n_f, parms_id, "relu", device)
    lim_s = sign_cd.limb_constants
    L_s = len(sign_cd.parms.coeff_modulus)

    def step(ct_a, relin_key):
        gate = _plain_add_c0(sign_fn(ct_a, relin_key), one_s, lim_s)   # 1 + sign(a)
        return mul_out(ct_a[..., :L_s, :], gate, relin_key)

    return step, out_cd.parms_id, out_scale


def build_ckks_max(context: SealContext, scale: float, encoder, n_g: int = 1, n_f: int = 2,
                   parms_id=None, device=None):
    """Encrypted slotwise max(a, b) = ((a + b) + (a - b) sign(a - b)) / 2
    (the JAX package's build_ckks_max) for |a - b| <= 1: the (a + b) branch
    is multiplied by the ones-plaintext at the sign output's scale and
    rescaled by the same prime as the (a - b) sign(a - b) product, so both
    land at one scale; the /2 folds into out_scale.
    4 * (n_g + n_f) + 1 levels.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, ct_b, relin_key).
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    in_limbs = context.get_context_data(parms_id).limb_constants
    sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale = _sign_gate(
        context, scale, encoder, n_g, n_f, parms_id, "max", device)
    lim_s = sign_cd.limb_constants
    L_s = len(sign_cd.parms.coeff_modulus)

    def step(ct_a, ct_b, relin_key):
        diff = sub_poly(ct_a.contiguous(), ct_b.contiguous(), in_limbs)
        v = mul_out(diff[..., :L_s, :], sign_fn(diff, relin_key), relin_key)
        tot = add_poly(ct_a[..., :L_s, :].contiguous(), ct_b[..., :L_s, :].contiguous(), lim_s)
        return add_poly(_plain_mul_rescale(tot, one_s, sign_cd), v, out_cd.limb_constants)

    return step, out_cd.parms_id, out_scale


def _contract_pairs(a, b, limbs: LimbConstants):
    """out[g] = sum_k a[g, k] * b[g, k] mod p: products of two ciphertexts'
    components summed over k, one ``contract`` launch with the rows g as its
    groups (its pairwise mode), exact in 128 bits.

    a, b: int64[G, K, L, N]; returns int64[G, L, N]."""
    return contract_mulmod_128(a.contiguous().unsqueeze(0), b.contiguous(), limbs.p.reshape(-1),
                               limbs.ratio0.reshape(-1), limbs.ratio1.reshape(-1),
                               pairwise=True).squeeze(0)


def build_ckks_matmul_square(context: SealContext, d: int, scale: float, encoder,
                             parms_id=None, heads: int = 1, device=None):
    """Encrypted d x d matrix product of two row-major packed matrices
    (Jiang-Kim-Lauter-Song; the JAX package's build_ckks_matmul_square):
    C = sum_k phi^k(sigma(A)) (*) psi^k(tau(B)), three levels.

    sigma and tau are hoisted matvecs at the scale q_0 (fused mod-down);
    the column shifts phi^k and the row shifts psi^k are two hoisted
    rotation sets at level 1.  Each term's masked A side m_lo (*) rot +
    m_hi (*) rot' is one ``contract`` launch over all terms (two weights a
    term, the phi masks encoded at q_1); the degree-2 product
    sum_k a_k (*) b_k is three launches of the contraction's pairwise mode
    (components 0, 1 and 2), relinearized once, then rescaled twice.
    heads > 1 packs H independent products in d^2-slot blocks: tau and
    psi^k split into in-block and wrapped parts and the block masks fold
    into the A side (2d - 1 terms).  Every value is the JAX function's bit
    for bit.

    Returns (fn, out_parms_id, out_scale): fn(ctA, ctB, rot_keys_stack,
    relin_key) with rot_keys_stack ordered by fn.rot_steps.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    s = encoder.slot_count
    if d < 2 or heads < 1 or heads * d * d != s:
        raise ValueError(f"need d >= 2 with heads*d*d == slots ({heads}*{d}^2 != {s})")
    P = d * d                                   # block (head) size
    ids = _level_ids(context, parms_id, 3, "matmul")
    cds = [context.get_context_data(i) for i in ids]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    lim = cds[1].limb_constants
    dev = context.device

    Dl = float(scale)
    u_idx = np.arange(s) % P                    # within-block offset
    i_idx = u_idx // d
    j_idx = u_idx % d

    # sigma: offset k masks j < d-k of row k, offset k-d the wrapped tail
    sigma_diags = {}
    for k in range(d):
        m_lo_s = ((i_idx == k) & (j_idx < d - k)).astype(float)
        if m_lo_s.any():
            sigma_diags[k] = m_lo_s.tolist()
        if k:
            m_hi_s = ((i_idx == k) & (j_idx >= d - k)).astype(float)
            sigma_diags[(k - d) % s] = m_hi_s.tolist()
    # tau: offset d*j selects column j; with several heads the rows i >= d-j
    # ride the wrapped offset d*j - P
    tau_diags = {}
    for j in range(d):
        if heads == 1:
            tau_diags[d * j] = (j_idx == j).astype(float).tolist()
            continue
        lo = ((j_idx == j) & (i_idx < d - j)).astype(float)
        if lo.any():
            tau_diags[d * j] = lo.tolist()
        if j:
            hi = ((j_idx == j) & (i_idx >= d - j)).astype(float)
            tau_diags[(d * j - P) % s] = hi.tolist()

    sigma_fn = build_ckks_matvec(context, sigma_diags, q[0], encoder, parms_id=ids[0],
                                 device=device)
    tau_fn = build_ckks_matvec(context, tau_diags, q[0], encoder, parms_id=ids[0],
                               device=device)

    stepsA = sorted({k for k in range(1, d)} | {s - d + k for k in range(1, d)})
    stepsB = sorted({d * k for k in range(1, d)}
                    | ({(d * k - P) % s for k in range(1, d)} if heads > 1 else set()))
    rotA_fn = build_ckks_rotate_many(context, stepsA, parms_id=ids[1], device=device)
    rotB_fn = build_ckks_rotate_many(context, stepsB, parms_id=ids[1], device=device)
    # source rows: 0 the unrotated sigma(A) / tau(B), 1 + r the r-th rotation
    posA = {st: 1 + r for r, st in enumerate(stepsA)}
    posB = {st: 1 + r for r, st in enumerate(stepsB)}

    # the phi^k masks (heads > 1: intersected with psi^k's block masks, _p
    # beside the in-place row shift d*k, _w beside its wrapped twin d*k - P),
    # and one zero mask for the unshifted term's absent wrap
    preds = {("lo", k): j_idx < d - k for k in range(d)}
    preds.update({("hi", k): j_idx >= d - k for k in range(1, d)})
    if heads > 1:
        preds = {(side + "_p", k): pr & (i_idx < d - k) for (side, k), pr in preds.items()}
        preds.update({("lo_w", k): (j_idx < d - k) & (i_idx >= d - k) for k in range(1, d)})
        preds.update({("hi_w", k): (j_idx >= d - k) & (i_idx >= d - k) for k in range(1, d)})
    preds["zero"] = np.zeros(s, dtype=bool)
    mask_keys = list(preds)
    masks = encoder.encode_stack([preds[m].astype(float).tolist() for m in mask_keys], q[1],
                                 ids[1])
    mpos = {m: i for i, m in enumerate(mask_keys)}

    # the contraction's terms: (A base row, its mask, A wrap row, its mask, B row)
    sfx = "_p" if heads > 1 else ""
    terms = [(0, ("lo" + sfx, 0), 0, "zero", 0)]
    for k in range(1, d):
        base, wrap = posA[k], posA[s - d + k]
        terms.append((base, ("lo" + sfx, k), wrap, ("hi" + sfx, k), posB[d * k]))
        if heads > 1:
            terms.append((base, ("lo_w", k), wrap, ("hi_w", k), posB[(d * k - P) % s]))
    T = len(terms)
    a_rows = [r for t in terms for r in (t[0], t[2])]
    b_rows = [t[4] for t in terms]
    w_masks = masks[torch.tensor([mpos[m] for t in terms for m in (t[1], t[3])],
                                 device=dev)].reshape(T, 2, *masks.shape[-2:])

    # master key order: union of every consumer's sorted step set
    rot_steps = sorted(set(sorted(sigma_diags) + list(tau_diags)) | set(stepsA) | set(stepsB))
    rot_steps = [st for st in rot_steps if st != 0]
    midx = {st: i for i, st in enumerate(rot_steps)}

    def key_index(steps):
        return torch.tensor([midx[st] for st in steps], dtype=torch.int64, device=dev)

    idx_sigma = key_index([st for st in sorted(sigma_diags) if st != 0])
    idx_tau = key_index([st for st in sorted(tau_diags) if st != 0])
    idx_A, idx_B = key_index(stepsA), key_index(stepsB)
    relin_plan = KeySwitchPlan(context, ids[1])

    def _rescale(ct, lvl):
        return divide_and_round_q_last_ntt(ct, cds[lvl].device_rns_tool, cds[lvl].ntt_tables)

    def rows_by_component(base, rot, picks):
        """The picked source rows [2, B, len(picks), L, N], components first:
        row 0 is base [B, 2, L, N], row 1 + r the rotation rot[r]."""
        src = [base] + list(rot.unbind(0))
        return torch.stack([src[r].transpose(0, 1) for r in picks], dim=2)

    def step(ctA, ctB, rot_keys_stack, relin_key):
        lead = ctA.shape[:-3]
        ctA = ctA.contiguous().reshape((-1,) + tuple(ctA.shape[-3:]))
        ctB = ctB.contiguous().reshape((-1,) + tuple(ctB.shape[-3:]))
        sA = _rescale(sigma_fn(ctA, rot_keys_stack.index_select(0, idx_sigma)), 0)
        tB = _rescale(tau_fn(ctB, rot_keys_stack.index_select(0, idx_tau)), 0)
        rA = rotA_fn(sA, rot_keys_stack.index_select(0, idx_A))    # [RA, B, 2, L1, N]
        rB = rotB_fn(tB, rot_keys_stack.index_select(0, idx_B))
        # every term's masked A side in one launch: a_t = m (*) base + m' (*) wrap
        a_in = rows_by_component(sA, rA, a_rows)                 # [2, B, 2T, L1, N]
        a = _contract(a_in.reshape(a_in.shape[:2] + (T, 2) + a_in.shape[-2:]), w_masks, lim)
        b = rows_by_component(tB, rB, b_rows)                    # [2, B, T, L1, N]
        # C (degree 2) = sum_k a_k (*) b_k, one pairwise contraction a component
        p0 = _contract_pairs(a[0], b[0], lim)
        p1 = _contract_pairs(torch.cat([a[0], a[1]], dim=1), torch.cat([b[1], b[0]], dim=1), lim)
        p2 = _contract_pairs(a[1], b[1], lim)
        # one relinearization of the degree-2 tail, then the two rescales
        # (q1: the mask scale, q2: one product prime)
        ct_k = compute_modup_digits(p2, relin_plan, True)
        d0, d1 = keyswitch_inner_product(ct_k, relin_key, relin_plan, True)
        out = torch.stack([add_poly(p0, d0, lim), add_poly(p1, d1, lim)], dim=-3)
        out = _rescale(_rescale(out, 1), 2)
        return out.reshape(lead + tuple(out.shape[-3:]))

    step.rot_steps = rot_steps
    out_scale = (Dl * Dl * q[1]) / (q[1] * q[2])
    return step, ids[3], out_scale


def attention_plan(d: int, msg_bound: float = 0.5, exp_degree: int = 4,
                   iters: int = None, recip_target: float = 1e-5):
    """Level/accuracy plan for `build_ckks_attention`.

    With Q/K/V slot values in [-msg_bound, msg_bound], the logits are
    bounded by B = sqrt(d) * msg_bound^2, so the softmax denominator
    rowsum lies in [d*e^-B, d*e^B] and the Goldschmidt seed error after
    the range reduction R = (rmin + rmax)/2 is |e_0| <= tanh(B).  When
    `iters` is None the smallest m with tanh(B)^(2^(m+1)) <= recip_target
    is chosen (a * x_m = 1 - e_0^(2^(m+1)), build_ckks_inverse).

    Returns (n_levels, iters, logit_bound):
    n_levels = 3 (QK^T) + exp_degree-1 (exp chain) + 1 (exp realign)
    + 1 (rowsum) + iters+1 (reciprocal) + 1 (P = E*recip)
    + 1 (P realign) + 3 (P @ V) = exp_degree + iters + 10.
    """
    import math as _math

    B = _math.sqrt(d) * msg_bound * msg_bound
    if iters is None:
        e0 = _math.tanh(B)
        m = 1
        while e0 ** (2 ** (m + 1)) > recip_target:
            m += 1
        iters = m
    return exp_degree + iters + 10, iters, B


def build_ckks_attention(context: SealContext, d: int, scale: float, encoder,
                         msg_bound: float = 0.5, iters: int = None, exp_mode: str = "cheby",
                         exp_degree: int = 4, recip_target: float = 1e-5, parms_id=None,
                         heads: int = 1, device=None):
    """Encrypted attention softmax(Q @ K^T / sqrt(d)) @ V with Q, K^T and V
    all encrypted, d x d row-major packed (the JAX package's
    build_ckks_attention; heads > 1 packs H independent heads in d^2-slot
    blocks, heads*d*d == slots).  Stages, each the JAX stage's values bit
    for bit: S = Q @ K^T (build_ckks_matmul_square, 3 levels); E = exp(S /
    sqrt(d)) by build_ckks_poly_eval (exp_mode "cheby": the degree
    exp_degree Chebyshev interpolant over the raw-logit window [-d mb^2,
    d mb^2]; "taylor": the degree-4 Maclaurin series), realigned to the
    scale Dl; the block row sum divided by R (a masked matvec, 1 level);
    the Goldschmidt reciprocal (build_ckks_inverse, iters + 1 levels);
    P = E * recip and its realignment (2 levels); out = P @ V (3 levels),
    with 1/R folded into out_scale.  exp_degree + iters + 10 levels
    (attention_plan).

    Returns (run, out_parms_id, out_scale, rot_steps): run(ctQ, ctKT, ctV,
    rot_keys_stack, relin_key) with rot_keys_stack stacked for rot_steps
    (the union over both matmuls and the row-sum map).
    """
    import math as _math

    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    s = encoder.slot_count
    if heads * d * d != s:
        raise ValueError(f"need heads*d*d == slots ({heads}*{d}^2 != {s})")
    Dl = float(scale)
    _, iters, _B = attention_plan(d, msg_bound, exp_degree, iters, recip_target)
    dev = context.device

    # stage 1: S = Q @ K^T (3 levels)
    mm1, pid_s, sc_s = build_ckks_matmul_square(context, d, Dl, encoder, parms_id=parms_id,
                                                heads=heads, device=device)

    # stage 2: E = exp(S / sqrt(d)) (exp_degree - 1 levels)
    a = 1.0 / _math.sqrt(d)
    if exp_mode == "cheby":
        Bs = d * msg_bound * msg_bound       # raw-logit (QK^T entry) bound
        ch = np.polynomial.chebyshev.Chebyshev.interpolate(
            lambda t, _a=a: np.exp(_a * t), exp_degree, domain=[-Bs, Bs])
        exp_coeffs = ch.convert(kind=np.polynomial.polynomial.Polynomial
                                ).coef.tolist()
    elif exp_mode == "taylor":
        if exp_degree != 4:
            raise ValueError("taylor mode is the pinned legacy degree-4")
        exp_coeffs = [a ** k / _math.factorial(k) for k in range(5)]
    else:
        raise ValueError(f"unknown exp_mode {exp_mode!r}")
    exp_fn, pid_e70, sc_e70 = build_ckks_poly_eval(context, exp_coeffs, sc_s, encoder,
                                                   parms_id=pid_s, device=device)

    # poly_eval lands at ~scale^2: one value-preserving realignment brings E
    # back to exactly Dl (1 level)
    cd_e70 = context.get_context_data(pid_e70)
    q_e70 = float(cd_e70.parms.coeff_modulus[-1].value)
    pt_align_e = encoder.encode(1.0, Dl * q_e70 / sc_e70, pid_e70).data
    pid_e = cd_e70.next_context_data.parms_id
    sc_e = Dl
    cd_e = context.get_context_data(pid_e)

    # stage 3: rowsum / R, a block-local masked matvec (1 level)
    bx = _math.sqrt(d) * msg_bound * msg_bound
    rmin, rmax = d * _math.exp(-bx), d * _math.exp(bx)
    R = 0.5 * (rmin + rmax)
    j_idx = np.arange(s) % d
    rs_diags = {}
    for o in range(d):
        lo = ((j_idx + o) < d).astype(float) / R     # stay in row
        hi = ((j_idx + o) >= d).astype(float) / R    # wrapped part
        if lo.any():
            rs_diags[o] = lo.tolist()
        if o and hi.any():
            rs_diags[o - d] = hi.tolist()
    q_e = float(cd_e.parms.coeff_modulus[-1].value)
    rs_fn = build_ckks_matvec(context, rs_diags, q_e, encoder, parms_id=pid_e, device=device)
    pid_r = cd_e.next_context_data.parms_id
    sc_r = sc_e                                       # scale-preserving

    # stage 4: recip = R / rowsum (iters + 1 levels)
    inv_fn, pid_i, sc_i = build_ckks_inverse(context, sc_r, encoder, iters=iters,
                                             parms_id=pid_r, device=device)
    cd_i = context.get_context_data(pid_i)
    L_i = len(cd_i.parms.coeff_modulus)

    # stage 5: P = E * recip (1 level), values R * softmax
    mul_p = build_ckks_mul_relin_rescale(context, pid_i, device=device)
    q_i = float(cd_i.parms.coeff_modulus[-1].value)
    pid_p = cd_i.next_context_data.parms_id
    sc_p = sc_e * sc_i / q_i

    # stage 6: realign P to exactly Dl (1 level)
    cd_p = context.get_context_data(pid_p)
    q_p = float(cd_p.parms.coeff_modulus[-1].value)
    pt_align = encoder.encode(1.0, Dl * q_p / sc_p, pid_p).data
    pid_p2 = cd_p.next_context_data.parms_id

    # stage 7: out = P @ V (3 levels); 1/R folds into out_scale
    mm2, pid_o, sc_o = build_ckks_matmul_square(context, d, Dl, encoder, parms_id=pid_p2,
                                                heads=heads, device=device)
    L_p2 = len(context.get_context_data(pid_p2).parms.coeff_modulus)
    out_scale = sc_o * R                  # values carry R*softmax @ V

    # one global rotation-key stack
    step_set = set(mm1.rot_steps) | set(mm2.rot_steps)
    step_set |= {st for st in rs_diags if st != 0}
    rot_steps = sorted(step_set)
    sidx = {st: i for i, st in enumerate(rot_steps)}

    def key_index(steps):
        return torch.tensor([sidx[st] for st in steps], dtype=torch.int64, device=dev)

    idx_mm1, idx_mm2 = key_index(mm1.rot_steps), key_index(mm2.rot_steps)
    idx_rs = key_index([st for st in sorted(rs_diags) if st != 0])

    def run(ctQ, ctKT, ctV, rot_keys_stack, relin_key):
        S = mm1(ctQ, ctKT, rot_keys_stack.index_select(0, idx_mm1), relin_key)
        E = _plain_mul_rescale(exp_fn(S, relin_key, None), pt_align_e, cd_e70)
        rsum = divide_and_round_q_last_ntt(
            rs_fn(E, rot_keys_stack.index_select(0, idx_rs)), cd_e.device_rns_tool,
            cd_e.ntt_tables)
        recip = inv_fn(rsum, relin_key)
        Pm = _plain_mul_rescale(mul_p(E[..., :L_i, :], recip, relin_key), pt_align, cd_p)
        return mm2(Pm, ctV[..., :L_p2, :], rot_keys_stack.index_select(0, idx_mm2), relin_key)

    return run, pid_o, out_scale, rot_steps
