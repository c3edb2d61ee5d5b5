"""Decryptor (reference: native/src/seal/decryptor.{h,cpp}).

Port of gemini_seal_tpu/decryptor.py.  BFV: the dot product sum_i c_i s^i
in the power basis (forward NTT of c_1.., products with the powers of s,
inverse NTT, plus c_0), then the exact {t, gamma} scale-and-round
(rns.cpp:1070-1126; kernels ``contract`` and ``scale_round``).  CKKS: the
NTT-domain dot product is the RNS NTT plaintext.
"""

from __future__ import annotations

import torch

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import SecretKey
from .ops.dyadic import add_poly, dyadic_product
from .ops.ntt import ntt_forward, ntt_inverse
from .ops.rnsops import decrypt_scale_and_round
from .params import PARMS_ID_ZERO, SchemeType

__all__ = ["Decryptor"]


class Decryptor:
    def __init__(self, context: SealContext, secret_key: SecretKey, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        if secret_key.parms_id != context.key_parms_id:
            raise ValueError("secret key is not valid for encryption parameters")
        self.device = context.check_device(device)
        self.context = context
        # powers of s cache at key level (decryptor.cpp:44-49, 151-208)
        self._sk_powers = [secret_key.data]

    def _compute_sk_powers(self, max_power: int):
        limbs = self.context.key_context_data().limb_constants
        while len(self._sk_powers) < max_power:
            self._sk_powers.append(
                dyadic_product(self._sk_powers[-1], self._sk_powers[0], limbs)
            )

    def _dot_product_ct_sk(self, encrypted: Ciphertext):
        """c_0 + c_1 s + ... + c_{k-1} s^{k-1} mod q, in the ciphertext's
        (NTT or power-basis) domain (decryptor.cpp:218-267)."""
        cd = self.context.get_context_data(encrypted.parms_id)
        limbs = cd.limb_constants
        L = encrypted.coeff_modulus_size
        self._compute_sk_powers(encrypted.size - 1)
        data = encrypted.data.to(self.device)
        cs = data[1:].contiguous()
        if not encrypted.is_ntt_form:
            cs = ntt_forward(cs, cd.ntt_tables)
        acc = None
        for i in range(encrypted.size - 1):
            term = dyadic_product(cs[i], self._sk_powers[i][:L].contiguous(), limbs)
            acc = term if acc is None else add_poly(acc, term, limbs)
        if not encrypted.is_ntt_form:
            acc = ntt_inverse(acc, cd.ntt_tables)
        return add_poly(acc, data[0].contiguous(), limbs)

    def decrypt(self, encrypted: Ciphertext) -> Plaintext:
        cd = self.context.get_context_data(encrypted.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV:
            if encrypted.is_ntt_form:
                raise ValueError("encrypted cannot be in NTT form")
            plain = decrypt_scale_and_round(self._dot_product_ct_sk(encrypted),
                                            cd.device_rns_tool)
            # trim to significant coefficients (decryptor.cpp:109-114)
            nz = torch.nonzero(plain)
            count = int(nz[-1, 0]) + 1 if nz.numel() else 1
            return Plaintext(data=plain[:count], parms_id=PARMS_ID_ZERO)
        if scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        if not encrypted.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        return Plaintext(data=self._dot_product_ct_sk(encrypted),
                         parms_id=encrypted.parms_id, scale=encrypted.scale)
