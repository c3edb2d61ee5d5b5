"""Plaintext and Ciphertext containers.

Port of gemini_seal_tpu/ciphertext.py (the reference's plaintext.h and
ciphertext.h): the reference's flat [size][L][N] array is a dense
``int64[size, L, N]`` tensor of u64 residues on one device, plus host-side
metadata.  Both classes are mutable dataclasses, as in the JAX package
(a caller may set ``scale``).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from .modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN
from .ops.backend import resolve_device, to_numpy, to_tensor
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

    @property
    def coeff_count(self) -> int:
        return int(self.data.numel())

    def significant_coeff_count(self) -> int:
        if self.is_ntt_form:
            return self.coeff_count
        nz = torch.nonzero(self.data)
        return int(nz[-1, 0]) + 1 if nz.numel() else 0

    @staticmethod
    def from_coeffs(coeffs, device=None) -> "Plaintext":
        """A BFV plaintext from its u64 coefficients (power basis) on
        ``device`` (None means the card)."""
        return Plaintext(data=to_tensor(np.asarray(coeffs, dtype=np.uint64),
                                        resolve_device(device)))

    @staticmethod
    def from_hex(hex_poly: str, device=None) -> "Plaintext":
        """Parse the reference's hex-polynomial format, e.g. '3x^2 + 1', into a
        BFV plaintext on ``device`` (None means the card)."""
        hex_poly = hex_poly.strip()
        terms = {}
        for term in hex_poly.replace("-", "+-").split("+"):
            term = term.strip()
            if not term:
                continue
            if "x^" in term:
                c, e = term.split("x^")
                c = c.strip() or "1"
            elif "x" in term:
                c = term.split("x")[0].strip() or "1"
                e = "1"
            else:
                c, e = term, "0"
            terms[int(e)] = int(c, 16)
        data = np.zeros((max(terms) if terms else 0) + 1, dtype=np.uint64)
        for e, c in terms.items():
            data[e] = c
        return Plaintext.from_coeffs(data, device=device)

    def to_hex(self) -> str:
        """Render as the reference's hex-polynomial string."""
        if self.is_ntt_form:
            raise ValueError("cannot render NTT-form plaintext as hex poly")
        coeffs = to_numpy(self.data)
        parts = []
        for e in range(len(coeffs) - 1, -1, -1):
            c = int(coeffs[e])
            if c == 0:
                continue
            if e == 0:
                parts.append(f"{c:x}")
            elif e == 1:
                parts.append(f"{c:x}x")
            else:
                parts.append(f"{c:x}x^{e}")
        return " + ".join(parts) if parts else "0"


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

    def copy(self) -> "Ciphertext":
        """A new Ciphertext sharing the data tensor (the ops never write into
        their inputs)."""
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale)

    def is_transparent(self) -> bool:
        """True if c_1.. are all zero: decryptable without the secret key
        (reference: ciphertext.h:700-707).  As in the JAX package, the check
        reads host data only: a tensor on the CPU is checked, a CUDA tensor
        counts as device data and returns False, so that no op waits on the
        card for it (the reference gates the check behind
        SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT)."""
        if self.size < CIPHERTEXT_SIZE_MIN:
            return True
        if self.data.device.type != "cpu":
            return False
        return not bool(self.data[1:].any())

    @staticmethod
    def zero(context_data, size: int = 2, is_ntt_form: bool = False) -> "Ciphertext":
        """All-zero ciphertext at a level, on the level's device."""
        if not CIPHERTEXT_SIZE_MIN <= size <= CIPHERTEXT_SIZE_MAX:
            raise ValueError("invalid ciphertext size")
        parms = context_data.parms
        shape = (size, len(parms.coeff_modulus), parms.poly_modulus_degree)
        return Ciphertext(torch.zeros(shape, dtype=torch.int64, device=context_data.device),
                          context_data.parms_id, is_ntt_form)
