"""Decryptor (reference: native/src/seal/decryptor.{h,cpp}).

Port of gemini_seal_tpu/decryptor.py.  BFV: the dot product sum_i c_i s^i
in the power basis (forward NTT of c_1.., products with the powers of s,
inverse NTT, plus c_0), then the exact {t, gamma} scale-and-round
(rns.cpp:1070-1126; kernels ``contract`` and ``scale_round``).  CKKS: the
NTT-domain dot product is the RNS NTT plaintext.  The BFV noise budget
takes the same dot product on the card and its multiply by t
(``elementwise``), then composes the residues by CRT and takes the centred
norm on the host with Python ints, as the JAX package does.  decrypt_batch
takes a batch u64[B, size, L, N] of ciphertexts of one level (a step's
output) through one pass of the same launches; plaintext b equals
decrypt() of ciphertext b.
"""

from __future__ import annotations

import torch

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import SecretKey
from .ops.backend import to_numpy, to_tensor
from .ops.dyadic import add_poly, dyadic_product, multiply_poly_scalar
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

    def decrypt_batch(self, data, parms_id, is_ntt_form: bool, scale: float = 1.0):
        """Decrypt a batch of ciphertexts held as one tensor
        int64[B, size, L, N] (or a host u64 array, uploaded to the
        decryptor's device), all of one level and form: the serving egress
        path.  One forward NTT of c_1.. (power basis only), one dyadic
        product and add a power of s, one inverse NTT, the add of c_0, and
        for BFV one scale-and-round, all over the batch.  Returns the list
        of Plaintexts that per-ciphertext decrypt() gives."""
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        if scheme == SchemeType.CKKS and not is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        if scheme not in (SchemeType.BFV, SchemeType.CKKS):
            raise ValueError("unsupported scheme")
        data = (data.to(self.device) if isinstance(data, torch.Tensor)
                else to_tensor(data, self.device))
        if data.dim() != 4:
            raise ValueError("decrypt_batch expects u64[B, size, L, N]")
        limbs = cd.limb_constants
        B, size, L, _ = data.shape
        self._compute_sk_powers(size - 1)
        cs = data[:, 1:].contiguous()
        if not is_ntt_form:
            cs = ntt_forward(cs, cd.ntt_tables)
        acc = None
        for i in range(size - 1):
            term = dyadic_product(cs[:, i].contiguous(), self._sk_powers[i][:L].contiguous(),
                                  limbs)
            acc = term if acc is None else add_poly(acc, term, limbs)
        if not is_ntt_form:
            acc = ntt_inverse(acc, cd.ntt_tables)
        acc = add_poly(acc, data[:, 0].contiguous(), limbs)        # [B, L, N]
        if scheme == SchemeType.CKKS:
            return [Plaintext(data=acc[b], parms_id=parms_id, scale=scale) for b in range(B)]
        plains = decrypt_scale_and_round(acc, cd.device_rns_tool)   # [B, N]
        # trim each to its significant coefficients (decryptor.cpp:109-114)
        pos = torch.arange(1, plains.shape[-1] + 1, device=plains.device)
        counts = torch.where(plains != 0, pos, 0).amax(dim=-1).clamp(min=1).tolist()
        return [Plaintext(data=plains[b, :c], parms_id=PARMS_ID_ZERO)
                for b, c in enumerate(counts)]

    def invariant_noise_budget(self, encrypted: Ciphertext) -> int:
        """Bits of noise budget remaining (decryptor.cpp:269-325)."""
        cd = self.context.get_context_data(encrypted.parms_id)
        if cd.parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        if encrypted.is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        limbs = cd.limb_constants
        t = torch.full_like(limbs.p, cd.parms.plain_modulus.value)
        noise = multiply_poly_scalar(self._dot_product_ct_sk(encrypted), t, limbs)
        # CRT-compose on the host and take the centred infinity norm
        big = cd.rns_base.compose_array(to_numpy(noise))
        q = cd.total_coeff_modulus
        half = q >> 1
        norm = 0
        for v in big:
            mag = q - v if v > half else v
            if mag > norm:
                norm = mag
        return max(0, cd.total_coeff_modulus_bit_count - norm.bit_length() - 1)
