"""Encryptor (reference: native/src/seal/encryptor.{h,cpp}).

Port of gemini_seal_tpu/encryptor.py.  BFV: a zero-encryption in the power
basis at the first level plus round(q/t * m) with the exact rounding fix
(scalingvariant, kernel ``scale_round``).  CKKS: a zero-encryption in NTT
form at the plaintext's level plus the NTT-domain plaintext.  Public-key
zero-encryptions below the key level are made one level up and
mod-switched down (encryptor.cpp:144-173); symmetric ones (secret key) are
made at their level.  The seeded forms return a SerializableCiphertext that
saves c0 and the 64-byte c1 seed (Serializable<Ciphertext>).
"""

from __future__ import annotations

from typing import Optional

import torch

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import PublicKey, SecretKey
from .ops.dyadic import add_poly
from .ops.rnsops import (divide_and_round_q_last, divide_and_round_q_last_ntt,
                         multiply_add_plain_with_scaling_variant)
from .params import SchemeType
from .rlwe import encrypt_zero_asymmetric, encrypt_zero_symmetric
from .utils.prng import random_seed

__all__ = ["Encryptor"]


class Encryptor:
    def __init__(self, context: SealContext, public_key: Optional[PublicKey] = None,
                 secret_key: Optional[SecretKey] = None, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        if public_key is None and secret_key is None:
            raise ValueError("need a public or secret key")
        self.device = context.check_device(device)
        self.context = context
        self.public_key = public_key
        self.secret_key = secret_key

    # -- public API -------------------------------------------------------
    def encrypt(self, plain: Plaintext) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=True)

    def encrypt_symmetric(self, plain: Plaintext) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=False)

    def encrypt_zero(self, parms_id=None, is_asymmetric: bool = True) -> Ciphertext:
        if parms_id is None:
            parms_id = self.context.first_parms_id
        return self._encrypt_zero_internal(parms_id, is_asymmetric)

    def encrypt_zero_symmetric(self, parms_id=None) -> Ciphertext:
        return self.encrypt_zero(parms_id, is_asymmetric=False)

    def _fresh_c1_seed(self) -> tuple:
        """c1 seed for seeded encryption: fresh entropy, or (as every other
        sampling path) a deterministic derivation when the parameter seed is
        pinned for reproducibility.

        The pinned-seed counter is context-global, not per-Encryptor: two
        Encryptors over the same pinned context draw distinct c1 streams, so
        the nonce-reuse pattern (one c1 across two messages leaks their
        difference through c0 - c0' = Delta(m1 - m2) + e - e') cannot occur
        within a process.  Pinned seeds are for tests only: two processes
        that share one pinned seed still collide, so never pin
        parms.random_seed in production.
        """
        pinned = self.context.key_context_data().parms.random_seed
        if pinned is not None:
            c = getattr(self.context, "_seeded_c1_counter", 0) + 1
            self.context._seeded_c1_counter = c
            return tuple((s ^ 0x5A5A5A5A5A5A5A5A ^ c) & 0xFFFFFFFFFFFFFFFF for s in pinned)
        return random_seed()

    # -- seeded (Serializable<Ciphertext>) variants -----------------------
    def encrypt_symmetric_serializable(self, plain: Plaintext):
        """Seed-compressed symmetric encryption: the returned wrapper saves
        at half size, c0 and the c1 seed (reference: Encryptor::
        encrypt_symmetric returning Serializable<Ciphertext>, seed flow
        rlwe.cpp:295-301)."""
        from .serialization import SerializableCiphertext

        seed = self._fresh_c1_seed()
        return SerializableCiphertext(
            self._encrypt_internal(plain, is_asymmetric=False, c1_seed=seed), seed)

    def encrypt_zero_symmetric_serializable(self, parms_id=None):
        from .serialization import SerializableCiphertext

        if parms_id is None:
            parms_id = self.context.first_parms_id
        seed = self._fresh_c1_seed()
        return SerializableCiphertext(self._encrypt_zero_internal(parms_id, False, c1_seed=seed),
                                      seed)

    # -- internals --------------------------------------------------------
    def _encrypt_zero_internal(self, parms_id, is_asymmetric: bool, c1_seed=None) -> Ciphertext:
        ctx = self.context
        cd = ctx.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        is_ntt_form = cd.parms.scheme == SchemeType.CKKS
        if not is_asymmetric:
            if self.secret_key is None:
                raise ValueError("secret key is not set")
            return encrypt_zero_symmetric(self.secret_key, ctx, parms_id, is_ntt_form,
                                          c1_seed=c1_seed)
        if self.public_key is None:
            raise ValueError("public key is not set")
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

    def _encrypt_internal(self, plain: Plaintext, is_asymmetric: bool,
                          c1_seed=None) -> Ciphertext:
        scheme = self.context.key_context_data().parms.scheme
        if scheme == SchemeType.BFV:
            if plain.is_ntt_form:
                raise ValueError("plain cannot be in NTT form")
            cd = self.context.first_context_data()
            ct = self._encrypt_zero_internal(cd.parms_id, is_asymmetric, c1_seed=c1_seed)
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
        ct = self._encrypt_zero_internal(plain.parms_id, is_asymmetric, c1_seed=c1_seed)
        # c0 += m in NTT domain (encryptor.cpp:227-252)
        c0 = add_poly(ct.data[0], plain.data, cd.limb_constants)
        return Ciphertext(data=torch.stack([c0, ct.data[1]]), parms_id=ct.parms_id,
                          is_ntt_form=True, scale=plain.scale)
