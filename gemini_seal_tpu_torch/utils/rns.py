"""Host-side RNS basis with exact CRT precomputes.

Port of the RNSBase part of gemini_seal_tpu/utils/rns.py (reference:
native/src/seal/util/rns.{h,cpp}).  The BFV base-conversion tool
(BaseConverter, RNSTool) comes with the BFV slice; the CKKS path needs
only the q_last constants, which ops/rnsops.DeviceRNSTool derives.
"""

from __future__ import annotations

from typing import List, Sequence

from ..modulus import Modulus
from . import numth

__all__ = ["RNSBase"]


class RNSBase:
    """A coprime RNS basis {q_i} with exact CRT precomputes.

    Reference: RNSBase (rns.h:20-125, rns.cpp:18-290).  All big-integer
    quantities are Python ints here; `punctured_prod_mod(p)` etc. derive the
    u64 constants the kernels need.
    """

    def __init__(self, moduli: Sequence):
        base = [m if isinstance(m, Modulus) else Modulus(int(m)) for m in moduli]
        if not base:
            raise ValueError("rnsbase cannot be empty")
        for i in range(len(base)):
            if base[i].is_zero():
                raise ValueError("rnsbase is invalid")
            for j in range(i):
                if not numth.are_coprime(base[i].value, base[j].value):
                    raise ValueError("rnsbase is invalid (not coprime)")
        self.base: List[Modulus] = base
        self.size = len(base)

        # CRT data (rns.cpp:237-290)
        self.base_prod: int = 1
        for m in base:
            self.base_prod *= m.value
        self.punctured_prod: List[int] = [self.base_prod // m.value for m in base]
        self.inv_punctured_prod_mod_base: List[int] = []
        for i, m in enumerate(base):
            inv = numth.try_invert_uint_mod(self.punctured_prod[i] % m.value, m.value)
            if inv is None:
                raise ValueError("rnsbase is invalid (punctured product not invertible)")
            self.inv_punctured_prod_mod_base.append(inv)

    def __getitem__(self, i: int) -> Modulus:
        return self.base[i]

    def values(self) -> List[int]:
        return [m.value for m in self.base]

    def decompose(self, value: int) -> List[int]:
        """Big int -> residues (rns.cpp:292-316)."""
        return [value % m.value for m in self.base]

    def compose(self, residues: Sequence[int]) -> int:
        """Residues -> big int in [0, base_prod) via CRT (rns.cpp:369-414)."""
        if len(residues) != self.size:
            raise ValueError("wrong residue count")
        acc = 0
        for i, m in enumerate(self.base):
            tmp = (residues[i] * self.inv_punctured_prod_mod_base[i]) % m.value
            acc = (acc + tmp * self.punctured_prod[i]) % self.base_prod
        return acc
