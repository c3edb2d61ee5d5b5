"""Evaluator: the modulus-switching part of the per-op API.

Port of these methods of gemini_seal_tpu/evaluator.py (the reference's
evaluator.cpp:829-994): mod_switch_to_next and mod_switch_to for both
schemes.  CKKS drops the last prime of an NTT-form ciphertext (the data is
sliced, the scale kept); BFV divides by the last prime with rounding in the
power basis (divide_and_round_q_last: ``elementwise`` and ``contract``
launches), or, with ``fused`` and two or more levels, by the product of all
dropped primes at once (divide_and_round_multi).  The rest of the class
comes with a later slice.
"""

from __future__ import annotations

import math
from typing import Dict

from .ciphertext import Ciphertext
from .context import ContextData, SealContext
from .ops.rnsops import (MultiDropPlan, divide_and_round_multi, divide_and_round_q_last,
                         divide_and_round_q_last_ntt)
from .params import SchemeType

__all__ = ["Evaluator"]


class Evaluator:
    def __init__(self, context: SealContext, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.device = context.check_device(device)
        self.context = context
        self._md_plans: Dict[tuple, MultiDropPlan] = {}

    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        return cd

    def _scheme(self) -> SchemeType:
        return self.context.key_context_data().parms.scheme

    def _check_scale_bounds(self, scale: float, cd: ContextData):
        if scale <= 0 or int(math.log2(scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

    def _mod_switch_scale_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """Rounded division by the last prime (reference: evaluator.cpp:829-892)."""
        cd = self._cd(encrypted)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and encrypted.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme == SchemeType.CKKS and not encrypted.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        tool = cd.device_rns_tool
        data = encrypted.data.contiguous()
        if scheme == SchemeType.BFV:
            data = divide_and_round_q_last(data, tool)
        else:
            data = divide_and_round_q_last_ntt(data, tool, cd.ntt_tables)
        new_scale = encrypted.scale
        if scheme == SchemeType.CKKS:
            new_scale = encrypted.scale / cd.parms.coeff_modulus[-1].value
        return Ciphertext(data, next_cd.parms_id, encrypted.is_ntt_form, new_scale)

    def _mod_switch_drop_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """Drop the last prime, keep the scale (reference: evaluator.cpp:894-994)."""
        cd = self._cd(encrypted)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        next_L = len(next_cd.parms.coeff_modulus)
        self._check_scale_bounds(encrypted.scale, next_cd)
        return Ciphertext(encrypted.data[:, :next_L, :].contiguous(), next_cd.parms_id,
                          encrypted.is_ntt_form, encrypted.scale)

    def mod_switch_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        if self._scheme() == SchemeType.BFV:
            return self._mod_switch_scale_to_next(encrypted)
        return self._mod_switch_drop_to_next(encrypted)

    def mod_switch_to(self, encrypted: Ciphertext, parms_id, fused: bool = False) -> Ciphertext:
        """Switch down to `parms_id` one level at a time; with ``fused`` a BFV
        ciphertext dropping two or more levels takes one rounded division by
        the product of the dropped primes (decrypts identically to the
        per-level chain, not bit-identical to it)."""
        cd = self._cd(encrypted)
        target = self.context.get_context_data(parms_id)
        if target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        levels = cd.chain_index - target.chain_index
        if (fused and levels >= 2 and cd.parms.scheme == SchemeType.BFV
                and not encrypted.is_ntt_form):
            key = (tuple(encrypted.parms_id), levels)
            plan = self._md_plans.get(key)
            if plan is None:
                plan = self._md_plans[key] = MultiDropPlan(self.context, encrypted.parms_id,
                                                           levels)
            data = divide_and_round_multi(encrypted.data.contiguous(), plan)
            return Ciphertext(data, tuple(parms_id), False, encrypted.scale)
        out = encrypted
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_to_next(out)
        return out
