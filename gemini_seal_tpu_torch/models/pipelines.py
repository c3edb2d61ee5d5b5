"""Evaluation pipelines over raw ciphertext tensors.

Port of the CKKS multiply + relinearize + rescale step of
gemini_seal_tpu/models/pipelines.py in its fused form.  Every step takes
ciphertext data shaped [..., size, L, N] with any leading batch axes, as
the JAX functions do.  PyTorch runs eagerly; each modular-arithmetic stage
is one launch of a hand-written kernel (``tensor_product``, ``ntt``,
``contract``, ``elementwise``) on the context's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..context import SealContext
from ..ops import cuda
from ..ops.backend import is_cuda
from ..ops.dyadic import LimbConstants
from ..ops.keyswitch import (KeySwitchPlan, compute_modup_digits, fused_moddown,
                             keyswitch_inner_product)
from ..ops.modops import add_mod, mul_mod

__all__ = ["build_ckks_mul_relin_rescale", "tensor_product_plain"]


def tensor_product_plain(a, b, limbs: LimbConstants):
    """Plain version of the ``tensor_product`` kernel: _convolve3
    (b given) or _square3 (b None) of the JAX package
    (pipelines.py:72-99), with dyadic_product = mul_mod and add_poly =
    add_mod."""
    p, r0, r1 = limbs.p, limbs.ratio0, limbs.ratio1
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    if b is None:
        cross = mul_mod(a0, a1, p, r0, r1)
        return (mul_mod(a0, a0, p, r0, r1), add_mod(cross, cross, p),
                mul_mod(a1, a1, p, r0, r1))
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
    c1 = add_mod(mul_mod(a0, b1, p, r0, r1), mul_mod(a1, b0, p, r0, r1), p)
    return mul_mod(a0, b0, p, r0, r1), c1, mul_mod(a1, b1, p, r0, r1)


def _tensor_product(a, b, limbs: LimbConstants):
    """(c0, c1, c2) of a size-2 x size-2 product (b None: square a).

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
    shape = a.shape[:-3] + (L, N)
    outs = [torch.empty(shape, dtype=torch.int64, device=a.device) for _ in range(3)]
    if a.numel() == 0:
        return tuple(outs)
    cuda.call("tensor_product", *(cuda.ptr(o) for o in outs), cuda.ptr(a), cuda.ptr(b),
              a.numel() // (2 * L * N), L, N, cuda.ptr(limbs.p),
              cuda.ptr(limbs.ratio0), cuda.ptr(limbs.ratio1))
    return tuple(outs)


def build_ckks_mul_relin_rescale(context: SealContext, parms_id=None,
                                 square: bool = False, device=None) -> Callable:
    """fn(ct_a, ct_b, relin_key) -> next-level ciphertext data.

    ct_*: int64[..., 2, L, N] (NTT form); relin_key: int64[n_bundles, 2,
    L_key, N], all on the context's device (None means the card).  Returns
    int64[..., 2, L-1, N], bit-identical to the JAX package's step built
    with fused=True: the rescale is merged into the key-switch mod-down (one
    division by P*q_last).  The JAX package's sequential form (fused=False)
    is not ported yet, so this builder has no ``fused`` option.

    square=True returns fn(ct, relin_key) using the 3-product square.
    """
    context.check_device(device)
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    plan = KeySwitchPlan(context, parms_id)
    plan.fused_drop_constants()

    def step_fused(a, b, relin_key):
        c0, c1, c2 = _tensor_product(a.contiguous(), None if b is None else b.contiguous(),
                                     limbs)
        ct_k = compute_modup_digits(c2, plan, True)
        acc0, acc1 = keyswitch_inner_product(ct_k, relin_key, plan, True, raw=True)
        out0 = fused_moddown(c0, acc0, plan)
        out1 = fused_moddown(c1, acc1, plan)
        return torch.stack([out0, out1], dim=-3)

    if square:
        return lambda a, relin_key: step_fused(a, None, relin_key)
    return step_fused
