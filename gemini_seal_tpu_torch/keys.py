"""Key objects (reference: secretkey.h, publickey.h, kswitchkeys.{h,cpp},
relinkeys.h, galoiskeys.h).

Port of gemini_seal_tpu/keys.py.  SecretKey wraps an NTT-form
[L_key, N] poly; PublicKey wraps a size-2 ciphertext at the key level;
KSwitchKeys is a list (per key) of lists (per decomposition bundle) of
PublicKeys — the fork's bundle-wise hybrid key-switching layout
(keygenerator.cpp:325-369), for relinearization and Galois keys alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from .ciphertext import Ciphertext
from .params import PARMS_ID_ZERO, ParmsId

__all__ = ["SecretKey", "PublicKey", "KSwitchKeys", "RelinKeys", "GaloisKeys"]


@dataclass
class SecretKey:
    """Ternary secret in NTT form at the key level (keygenerator.cpp:66-103)."""

    data: torch.Tensor                   # int64[L_key, N], NTT form
    parms_id: ParmsId = PARMS_ID_ZERO


@dataclass
class PublicKey:
    """Encryption of zero under the secret key, NTT form, key level."""

    data: Ciphertext
    parms_id: ParmsId = PARMS_ID_ZERO


@dataclass
class KSwitchKeys:
    """keys[key_index][bundle] -> PublicKey (kswitchkeys.h:36)."""

    keys: List[List[PublicKey]] = field(default_factory=list)
    parms_id: ParmsId = PARMS_ID_ZERO

    def size(self) -> int:
        return sum(1 for k in self.keys if k)

    def data(self, index: int) -> List[PublicKey]:
        if index >= len(self.keys) or not self.keys[index]:
            raise ValueError("keyswitching key does not exist")
        return self.keys[index]

    def stacked(self, *indices) -> torch.Tensor:
        """Key tensor(s) for the pipelines: one index ->
        int64[n_bundles, 2, L_key, N]; several -> a stacked
        int64[n_indices, n_bundles, 2, L_key, N] (the ``keys_stack`` of
        the hoisted rotations).  Indices use the subclass meaning:
        key_power for RelinKeys, galois_elt for GaloisKeys."""
        def one(i):
            return torch.stack([pk.data.data for pk in self.key(i)])

        if len(indices) == 1:
            return one(indices[0])
        return torch.stack([one(i) for i in indices])


class RelinKeys(KSwitchKeys):
    """Relinearization keys: key_index k holds keys for s^(k+2)
    (relinkeys.h)."""

    @staticmethod
    def get_index(key_power: int) -> int:
        if key_power < 2:
            raise ValueError("key_power cannot be less than 2")
        return key_power - 2

    def has_key(self, key_power: int) -> bool:
        idx = self.get_index(key_power)
        return idx < len(self.keys) and bool(self.keys[idx])

    def key(self, key_power: int) -> List[PublicKey]:
        return self.data(self.get_index(key_power))


class GaloisKeys(KSwitchKeys):
    """Galois automorphism keys indexed by Galois element (galoiskeys.h)."""

    @staticmethod
    def get_index(galois_elt: int) -> int:
        if galois_elt % 2 == 0 or galois_elt < 3:
            raise ValueError("galois_elt is not valid")
        return (galois_elt - 1) >> 1

    def has_key(self, galois_elt: int) -> bool:
        idx = self.get_index(galois_elt)
        return idx < len(self.keys) and bool(self.keys[idx])

    def key(self, galois_elt: int) -> List[PublicKey]:
        return self.data(self.get_index(galois_elt))
