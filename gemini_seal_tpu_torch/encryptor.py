"""Encryptor, public key (reference: native/src/seal/encryptor.{h,cpp}).

Port of the public-key path of gemini_seal_tpu/encryptor.py.  BFV: a
zero-encryption in the power basis at the first level plus round(q/t * m)
with the exact rounding fix (scalingvariant, kernel ``scale_round``).
CKKS: a zero-encryption in NTT form at the plaintext's level plus the
NTT-domain plaintext.  A zero-encryption below the key level is made one
level up and mod-switched down (encryptor.cpp:144-173).  Symmetric and
seeded encryption come with later slices.
"""

from __future__ import annotations

import torch

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import PublicKey
from .ops.dyadic import add_poly
from .ops.rnsops import (divide_and_round_q_last, divide_and_round_q_last_ntt,
                         multiply_add_plain_with_scaling_variant)
from .params import SchemeType
from .rlwe import encrypt_zero_asymmetric

__all__ = ["Encryptor"]


class Encryptor:
    def __init__(self, context: SealContext, public_key: PublicKey, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        if public_key is None:
            raise ValueError("need a public key")
        self.device = context.check_device(device)
        self.context = context
        self.public_key = public_key

    def encrypt_zero(self, parms_id=None) -> Ciphertext:
        ctx = self.context
        if parms_id is None:
            parms_id = ctx.first_parms_id
        cd = ctx.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        is_ntt_form = cd.parms.scheme == SchemeType.CKKS
        prev = cd.prev_context_data
        if prev is None:
            return encrypt_zero_asymmetric(self.public_key, ctx, parms_id, is_ntt_form)
        # encrypt at the previous level, then mod-switch down one step
        temp = encrypt_zero_asymmetric(self.public_key, ctx, prev.parms_id, is_ntt_form)
        if is_ntt_form:
            data = divide_and_round_q_last_ntt(temp.data, prev.device_rns_tool,
                                               prev.ntt_tables)
        else:
            data = divide_and_round_q_last(temp.data, prev.device_rns_tool)
        return Ciphertext(data=data, parms_id=cd.parms_id, is_ntt_form=is_ntt_form,
                          scale=temp.scale)

    def encrypt(self, plain: Plaintext) -> Ciphertext:
        scheme = self.context.key_context_data().parms.scheme
        if scheme == SchemeType.BFV:
            if plain.is_ntt_form:
                raise ValueError("plain cannot be in NTT form")
            cd = self.context.first_context_data()
            ct = self.encrypt_zero(cd.parms_id)
            # c0 += round(q/t * m) (scalingvariant.cpp:15-52)
            m = torch.zeros(cd.parms.poly_modulus_degree, dtype=torch.int64,
                            device=self.device)
            m[: plain.data.shape[0]] = plain.data
            c0 = multiply_add_plain_with_scaling_variant(ct.data[0], m, cd)
            return Ciphertext(data=torch.stack([c0, ct.data[1]]), parms_id=ct.parms_id,
                              is_ntt_form=False, scale=ct.scale)
        if scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        if not plain.is_ntt_form:
            raise ValueError("plain must be in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        ct = self.encrypt_zero(plain.parms_id)
        # c0 += m in NTT domain (encryptor.cpp:227-252)
        c0 = add_poly(ct.data[0], plain.data, cd.limb_constants)
        return Ciphertext(
            data=torch.stack([c0, ct.data[1]]),
            parms_id=ct.parms_id,
            is_ntt_form=True,
            scale=plain.scale,
        )
