"""Decryptor, CKKS (reference: native/src/seal/decryptor.{h,cpp}).

Port of the CKKS path of gemini_seal_tpu/decryptor.py: the NTT-domain dot
product sum_i c_i s^i is the RNS NTT plaintext.
"""

from __future__ import annotations

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import SecretKey
from .ops.dyadic import add_poly, dyadic_product

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

    def decrypt(self, encrypted: Ciphertext) -> Plaintext:
        """c_0 + c_1 s + ... + c_{k-1} s^{k-1} mod q in the NTT domain
        (decryptor.cpp:218-267)."""
        cd = self.context.get_context_data(encrypted.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        if not encrypted.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        limbs = cd.limb_constants
        L = encrypted.coeff_modulus_size
        self._compute_sk_powers(encrypted.size - 1)
        data = encrypted.data.to(self.device)
        acc = None
        for i in range(encrypted.size - 1):
            term = dyadic_product(data[i + 1].contiguous(),
                                  self._sk_powers[i][:L].contiguous(), limbs)
            acc = term if acc is None else add_poly(acc, term, limbs)
        return Plaintext(data=add_poly(acc, data[0].contiguous(), limbs),
                         parms_id=encrypted.parms_id, scale=encrypted.scale)
