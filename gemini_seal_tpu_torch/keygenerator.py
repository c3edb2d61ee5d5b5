"""KeyGenerator (reference: native/src/seal/keygenerator.{h,cpp}).

Port of gemini_seal_tpu/keygenerator.py.  Secret key: ternary poly in NTT
form at the key level.  Public key: symmetric zero-encryption.
Relinearization keys use the fork's bundle-wise hybrid key-switching keygen
(keygenerator.cpp:325-369): decomp_mod_count = ceil(n_ct_rns / n_sp_rns)
bundles, bundle b encrypting P * s'|_{bundle b} where P = prod of the
special primes; Galois keys encrypt the secret key under the automorphism
the same way.  Sampling is host-side; everything else runs on the context's
device.  The seed-compressed (serializable) keys come with a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .ciphertext import Ciphertext
from .context import SealContext
from .keys import GaloisKeys, PublicKey, RelinKeys, SecretKey
from .modulus import CIPHERTEXT_SIZE_MAX
from .ops.backend import to_tensor
from .ops.dyadic import dyadic_product
from .ops.modops import rns_elementwise
from .ops.ntt import ntt_forward
from .rlwe import encrypt_zero_symmetric, parms_rng
from .utils.prng import sample_poly_ternary

__all__ = ["KeyGenerator"]


class KeyGenerator:
    def __init__(self, context: SealContext, secret_key: Optional[SecretKey] = None,
                 device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.device = context.check_device(device)
        self.context = context
        cd = context.key_context_data()
        parms = cd.parms

        if secret_key is not None:
            self._secret_key = secret_key
        else:
            moduli = [m.value for m in parms.coeff_modulus]
            n = parms.poly_modulus_degree
            rng = parms_rng(parms)
            sk = to_tensor(sample_poly_ternary(rng, moduli, n), self.device)
            self._secret_key = SecretKey(data=ntt_forward(sk, cd.ntt_tables),
                                         parms_id=cd.parms_id)

        # powers-of-s cache (keygenerator.cpp:256-323): [power][L_key, N]
        self._sk_powers = [self._secret_key.data]
        self._public_key: Optional[PublicKey] = None

    @property
    def secret_key(self) -> SecretKey:
        return self._secret_key

    def public_key(self) -> PublicKey:
        if self._public_key is None:
            cd = self.context.key_context_data()
            ct = encrypt_zero_symmetric(
                self._secret_key, self.context, cd.parms_id, is_ntt_form=True
            )
            self._public_key = PublicKey(data=ct, parms_id=cd.parms_id)
        return self._public_key

    def _compute_sk_powers(self, max_power: int):
        limbs = self.context.key_context_data().limb_constants
        while len(self._sk_powers) < max_power:
            self._sk_powers.append(
                dyadic_product(self._sk_powers[-1], self._sk_powers[0], limbs)
            )

    def _generate_one_kswitch_key(self, new_key) -> List[PublicKey]:
        """Bundle-wise keys for switching from `new_key` (NTT form,
        [n_ct_rns(+), N]) back to the secret key
        (reference: keygenerator.cpp:325-369)."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise RuntimeError("keyswitching is not supported by the context")
        key_cd = ctx.key_context_data()
        key_modulus = key_cd.parms.coeff_modulus
        first_parms = ctx.first_context_data().parms
        n_ct_rns = len(first_parms.coeff_modulus)
        n_sp_rns = first_parms.n_special_primes
        decomp_mod_count = (n_ct_rns + n_sp_rns - 1) // n_sp_rns
        limbs = key_cd.limb_constants

        # factor[rns] = prod of special primes mod q_rns
        factors = np.zeros((n_ct_rns, 1), dtype=np.uint64)
        for rns in range(n_ct_rns):
            f = 1
            for k in range(n_sp_rns):
                f = (f * key_modulus[n_ct_rns + k].value) % key_modulus[rns].value
            factors[rns] = f
        factors = to_tensor(factors, self.device)

        out: List[PublicKey] = []
        for b in range(decomp_mod_count):
            ct = encrypt_zero_symmetric(
                self._secret_key, ctx, key_cd.parms_id, is_ntt_form=True
            )
            rns0 = b * n_sp_rns
            rns1 = min(rns0 + n_sp_rns, n_ct_rns)
            # c0[rns] += new_key[rns] * P mod q_rns for the bundle's limbs
            sl = limbs.slice(rns0, rns1)
            c0_sel = rns_elementwise(
                "muladd", new_key[rns0:rns1].contiguous(), sl.p, sl.ratio0, sl.ratio1,
                b=ct.data[0, rns0:rns1].contiguous(), s=factors[rns0:rns1],
            )
            data = ct.data.clone()
            data[0, rns0:rns1] = c0_sel
            ct = Ciphertext(data, ct.parms_id, ct.is_ntt_form, ct.scale)
            out.append(PublicKey(data=ct, parms_id=key_cd.parms_id))
        return out

    def relin_keys(self, count: int = 1) -> RelinKeys:
        """Keys for re-linearizing s^2 .. s^(count+1)
        (reference: keygenerator.cpp:138-178)."""
        if not 1 <= count <= CIPHERTEXT_SIZE_MAX - 2:
            raise ValueError("invalid count")
        self._compute_sk_powers(count + 1)
        rk = RelinKeys()
        rk.keys = [self._generate_one_kswitch_key(self._sk_powers[p])
                   for p in range(1, count + 1)]
        rk.parms_id = self.context.key_parms_id
        return rk

    def galois_keys(self, galois_elts: Optional[Sequence[int]] = None) -> GaloisKeys:
        """Keys for the Galois automorphisms x -> x^elt (reference:
        keygenerator.cpp:180-245), in element order; an element met twice
        gets one key.  The rotated secret key comes from one ``galois``
        launch."""
        ctx = self.context
        key_cd = ctx.key_context_data()
        galois_tool = key_cd.galois_tool
        if galois_elts is None:
            galois_elts = galois_tool.get_elts_all()
        n = key_cd.parms.poly_modulus_degree

        gk = GaloisKeys()
        max_index = max(GaloisKeys.get_index(e) for e in galois_elts)
        gk.keys = [[] for _ in range(max_index + 1)]
        for elt in galois_elts:
            if elt % 2 == 0 or elt >= 2 * n:
                raise ValueError("Galois element is not valid")
            idx = GaloisKeys.get_index(elt)
            if gk.keys[idx]:
                continue
            rotated = galois_tool.apply_galois_ntt(self._secret_key.data, elt)
            gk.keys[idx] = self._generate_one_kswitch_key(rotated)
        gk.parms_id = ctx.key_parms_id
        return gk

    def galois_keys_from_steps(self, steps: Sequence[int]) -> GaloisKeys:
        """Keys for a list of rotation steps (reference:
        KeyGenerator::galois_keys(const vector<int>&))."""
        tool = self.context.key_context_data().galois_tool
        return self.galois_keys(tool.get_elts_from_steps(list(steps)))
