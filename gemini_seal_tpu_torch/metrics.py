"""Ciphertext health metrics.

Port of gemini_seal_tpu/metrics.py.  The reference's only numeric health
signal is Decryptor::invariant_noise_budget (decryptor.cpp:269-325), polled
by hand; this module packages it with the other signals users steer by
(scale, level in the modulus chain, size, memory) as one snapshot.  The
structural metrics read metadata only; the BFV budget runs the Decryptor's
noise-budget path on the card (a ciphertext in NTT form is first lifted out
of it by an inverse ``ntt`` launch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .ciphertext import Ciphertext
from .context import SealContext
from .decryptor import Decryptor
from .ops.ntt import ntt_inverse
from .params import SchemeType

__all__ = ["CiphertextMetrics", "inspect"]


@dataclass(frozen=True)
class CiphertextMetrics:
    scheme: str
    size: int                      # number of polynomial components
    level: int                     # chain_index (levels remaining below)
    coeff_modulus_bits: int        # total log2 q at this level
    scale: float                   # CKKS scale (1.0 for BFV)
    log2_scale: float
    is_ntt_form: bool
    bytes: int                     # ciphertext tensor footprint
    noise_budget_bits: Optional[int]  # BFV only, requires a decryptor

    def headroom_ok(self, min_budget_bits: int = 10) -> bool:
        """BFV: decryption is safe while the budget stays positive; flag
        before it runs out (needs a snapshot taken with a Decryptor).  CKKS:
        flag when the scale no longer fits the remaining modulus."""
        if self.scheme == "BFV":
            if self.noise_budget_bits is None:
                raise ValueError(
                    "BFV noise headroom is unknown without a Decryptor; "
                    "call inspect(ct, ctx, decryptor)"
                )
            return self.noise_budget_bits >= min_budget_bits
        return self.log2_scale + min_budget_bits <= self.coeff_modulus_bits


def inspect(ct: Ciphertext, context: SealContext,
            decryptor: Optional[Decryptor] = None) -> CiphertextMetrics:
    """Snapshot a ciphertext's health metrics; a Decryptor (secret-key side
    only) adds the exact BFV invariant-noise budget."""
    cd = context.get_context_data(ct.parms_id)
    if cd is None:
        raise ValueError("ciphertext is not valid for the context")
    scheme = cd.parms.scheme
    budget = None
    if decryptor is not None and scheme == SchemeType.BFV:
        probe = ct
        if ct.is_ntt_form:
            # the budget is defined on the power basis: lift a copy out of NTT form
            probe = Ciphertext(ntt_inverse(ct.data.to(decryptor.device).contiguous(),
                                           cd.ntt_tables), ct.parms_id, False, ct.scale)
        budget = decryptor.invariant_noise_budget(probe)
    return CiphertextMetrics(
        scheme=scheme.name,
        size=ct.size,
        level=cd.chain_index,
        coeff_modulus_bits=cd.total_coeff_modulus_bit_count,
        scale=ct.scale,
        log2_scale=math.log2(ct.scale) if ct.scale > 0 else float("-inf"),
        is_ntt_form=ct.is_ntt_form,
        bytes=int(ct.data.numel()) * 8,
        noise_budget_bits=budget,
    )
