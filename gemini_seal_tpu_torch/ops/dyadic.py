"""Coefficient-wise polynomial ops over [..., L, N] residue tensors.

Port of gemini_seal_tpu/ops/dyadic.py (the reference's
polyarithsmallmod.{h,cpp} loops).  Each op broadcasts per-limb constants
shaped [L, 1] against data [..., L, N]; on the card each is one launch of
the ``elementwise`` kernel (csrc/elementwise.cu), on the CPU the plain
modops chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..modulus import Modulus
from .modops import rns_elementwise

__all__ = [
    "LimbConstants",
    "add_poly",
    "sub_poly",
    "negate_poly",
    "multiply_poly_scalar",
    "dyadic_product",
]


@dataclass(frozen=True)
class LimbConstants:
    """Per-limb modulus constants, broadcast-ready against [..., L, N].

    p, ratio0, ratio1: int64[L, 1] tensors holding u64 values
    (floor(2^128/p) low/high words — reference: modulus.h:122-129).
    """

    p: torch.Tensor
    ratio0: torch.Tensor
    ratio1: torch.Tensor

    @staticmethod
    def from_moduli(moduli, device) -> "LimbConstants":
        mods = [m if isinstance(m, Modulus) else Modulus(int(m)) for m in moduli]

        def col(vals):
            a = np.array(vals, dtype=np.uint64).reshape(-1, 1)
            return torch.from_numpy(a.view(np.int64).copy()).to(device)

        return LimbConstants(
            p=col([m.value for m in mods]),
            ratio0=col([m.const_ratio[0] for m in mods]),
            ratio1=col([m.const_ratio[1] for m in mods]),
        )

    def slice(self, lo: int, hi: int) -> "LimbConstants":
        return LimbConstants(self.p[lo:hi], self.ratio0[lo:hi], self.ratio1[lo:hi])


def _op(op, a, limbs: LimbConstants, b=None, s=None):
    return rns_elementwise(op, a, limbs.p, limbs.ratio0, limbs.ratio1, b=b, s=s)


def add_poly(a, b, limbs: LimbConstants):
    """(a + b) mod q_i per limb (polyarithsmallmod.h:261-360)."""
    return _op("add", a, limbs, b=b)


def sub_poly(a, b, limbs: LimbConstants):
    return _op("sub", a, limbs, b=b)


def negate_poly(a, limbs: LimbConstants):
    return _op("neg", a, limbs)


def multiply_poly_scalar(a, scalar, limbs: LimbConstants):
    """a * s_i mod q_i; scalar is an int64[L, 1] per-limb tensor
    (polyarithsmallmod.h:471-528)."""
    return _op("mul", a, limbs, b=scalar)


def dyadic_product(a, b, limbs: LimbConstants):
    """Hadamard product in NTT domain (polyarithsmallmod.h:530-597)."""
    return _op("mul", a, limbs, b=b)
