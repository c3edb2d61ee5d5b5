"""Plaintext and Ciphertext containers.

Port of gemini_seal_tpu/ciphertext.py (the reference's plaintext.h and
ciphertext.h): the reference's flat [size][L][N] array is a dense
``int64[size, L, N]`` tensor of u64 residues on one device, plus host-side
metadata.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .params import PARMS_ID_ZERO, ParmsId

__all__ = ["Plaintext", "Ciphertext"]


@dataclass
class Plaintext:
    """BFV: int64[count] coefficients mod t in the power basis, parms_id
    zero (count <= N: a decrypted plaintext is trimmed to its significant
    coefficients, decryptor.cpp:109-114).  CKKS: RNS NTT poly int64[L, N]
    tagged with parms_id and scale (reference: plaintext.h:58+)."""

    data: torch.Tensor
    parms_id: ParmsId = PARMS_ID_ZERO
    scale: float = 1.0

    @property
    def is_ntt_form(self) -> bool:
        return self.parms_id != PARMS_ID_ZERO


@dataclass
class Ciphertext:
    """size polynomials of L RNS limbs of N coefficients
    (reference: ciphertext.h:56+, data layout :709-721)."""

    data: torch.Tensor                    # int64[size, L, N]
    parms_id: ParmsId
    is_ntt_form: bool = False
    scale: float = 1.0

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    @property
    def coeff_modulus_size(self) -> int:
        return int(self.data.shape[1])

    @property
    def poly_modulus_degree(self) -> int:
        return int(self.data.shape[2])
