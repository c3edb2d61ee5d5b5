"""Host-side RNS machinery: CRT bases, base-conversion matrices, RNSTool.

Port of gemini_seal_tpu/utils/rns.py (reference:
native/src/seal/util/rns.{h,cpp}).  All exact-integer precompute runs on
Python ints when a context is built; the resulting numpy u64 tables feed
the device operations in :mod:`gemini_seal_tpu_torch.ops.rnsops`, where the
reference's scalar loops become batched contractions over the limb axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..modulus import (
    COEFF_MOD_COUNT_MAX,
    COEFF_MOD_COUNT_MIN,
    POLY_MOD_DEGREE_MAX,
    POLY_MOD_DEGREE_MIN,
    USER_MOD_BIT_COUNT_MAX,
    Modulus,
)
from . import mplimb, numth

INTERNAL_MOD_BIT_COUNT = 61  # reference: defines.h:37

__all__ = ["RNSBase", "BaseConverter", "RNSTool"]


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

    def contains(self, value: int) -> bool:
        return any(m.value == value for m in self.base)

    def is_subbase_of(self, superbase: "RNSBase") -> bool:
        return all(superbase.contains(m.value) for m in self.base)

    def extend(self, value) -> "RNSBase":
        v = value.value if isinstance(value, Modulus) else int(value)
        for m in self.base:
            if not numth.are_coprime(m.value, v):
                raise ValueError("cannot extend by given value")
        return RNSBase(self.base + [Modulus(v)])

    def extend_base(self, other: "RNSBase") -> "RNSBase":
        return RNSBase(self.base + other.base)

    def drop(self, count: int = 1) -> "RNSBase":
        if self.size <= count:
            raise ValueError("cannot drop from this base")
        return RNSBase(self.base[: self.size - count])

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

    def decompose_array(self, values: Sequence[int]) -> np.ndarray:
        """[count] big ints -> uint64[size, count] residue planes."""
        out = np.zeros((self.size, len(values)), dtype=np.uint64)
        for j, m in enumerate(self.base):
            mv = m.value
            out[j] = np.array([int(v) % mv for v in values], dtype=np.uint64)
        return out

    def compose_array(self, residues: np.ndarray) -> List[int]:
        """uint64[size, count] -> [count] big ints in [0, base_prod)
        (reference: rns.cpp:416-450)."""
        return mplimb.compose_ints(np.asarray(residues, dtype=np.uint64), self)


@dataclass
class BaseConverter:
    """BEHZ fast base conversion q-basis -> p-basis precompute.

    Reference: BaseConverter (rns.h:127-184, rns.cpp:452-553).  On the
    device the conversion is out[j, n] = sum_i matrix[j, i] * (x_i *
    inv_punctured_i) mod p_j: one ``contract`` launch with the inverse
    multiply as its pre-scale (ops/rnsops.fast_convert_array).
    """

    ibase: RNSBase
    obase: RNSBase
    matrix: np.ndarray = field(init=False)        # [O, I] punctured_prod_i mod p_j
    inv_punctured: np.ndarray = field(init=False)  # [I]

    def __post_init__(self):
        O, I = self.obase.size, self.ibase.size
        m = np.zeros((O, I), dtype=np.uint64)
        for j in range(O):
            pj = self.obase[j].value
            for i in range(I):
                m[j, i] = self.ibase.punctured_prod[i] % pj
        self.matrix = m
        self.inv_punctured = np.array(
            self.ibase.inv_punctured_prod_mod_base, dtype=np.uint64
        )


class RNSTool:
    """Per-level RNS toolbox constants (reference: RNSTool, rns.h:186-366).

    Holds the auxiliary bases for BFV multiplication (B, Bsk = B u {m_sk},
    Bsk u {m_tilde}), the {t, gamma} decrypt base, and every precomputed
    scalar from rns.cpp:539-729.  Pure host data; the device twin is
    ops/rnsops.DeviceRNSTool.
    """

    def __init__(self, poly_modulus_degree: int, q: RNSBase, t: Modulus):
        if q.size < COEFF_MOD_COUNT_MIN or q.size > COEFF_MOD_COUNT_MAX:
            raise ValueError("rnsbase is invalid")
        if (
            numth.get_power_of_two(poly_modulus_degree) < 0
            or poly_modulus_degree > POLY_MOD_DEGREE_MAX
            or poly_modulus_degree < POLY_MOD_DEGREE_MIN
        ):
            raise ValueError("poly_modulus_degree is invalid")

        self.coeff_count = poly_modulus_degree
        self.t = t
        self.base_q = q
        base_q_size = q.size

        # Auxiliary base sizing (rns.cpp:566-575): B grows by one prime when
        # 32 + |t| + |q| >= 61*(|base_q|+1) bits.
        total_coeff_bit_count = q.base_prod.bit_length()
        base_B_size = base_q_size
        if (
            32 + t.bit_count + total_coeff_bit_count
            >= INTERNAL_MOD_BIT_COUNT * base_q_size + INTERNAL_MOD_BIT_COUNT
        ):
            base_B_size += 1
        base_Bsk_size = base_B_size + 1
        base_Bsk_m_tilde_size = base_Bsk_size + 1

        # Sample the conversion primes: [m_sk, gamma, B...] (rns.cpp:586-595).
        baseconv_primes = numth.get_primes(
            poly_modulus_degree, USER_MOD_BIT_COUNT_MAX + 1, base_Bsk_m_tilde_size
        )
        self.m_sk = Modulus(baseconv_primes[0])
        self.gamma = Modulus(baseconv_primes[1])
        base_B_primes = baseconv_primes[2 : 2 + base_B_size]
        self.m_tilde = Modulus(1 << 32)

        self.base_B = RNSBase(base_B_primes)
        self.base_Bsk = self.base_B.extend(self.m_sk)
        self.base_Bsk_m_tilde = self.base_Bsk.extend(self.m_tilde)
        self.base_t_gamma: Optional[RNSBase] = None
        if not t.is_zero():
            self.base_t_gamma = RNSBase([t, self.gamma])

        # Base converters
        self.base_q_to_Bsk_conv = BaseConverter(self.base_q, self.base_Bsk)
        self.base_q_to_m_tilde_conv = BaseConverter(self.base_q, RNSBase([self.m_tilde]))
        self.base_B_to_q_conv = BaseConverter(self.base_B, self.base_q)
        self.base_B_to_m_sk_conv = BaseConverter(self.base_B, RNSBase([self.m_sk]))
        self.base_q_to_t_gamma_conv = (
            BaseConverter(self.base_q, self.base_t_gamma)
            if self.base_t_gamma is not None
            else None
        )

        # Scalar precomputes (rns.cpp:640-729)
        def inv_mod(x: int, m: Modulus) -> int:
            r = numth.try_invert_uint_mod(x % m.value, m.value)
            if r is None:
                raise ValueError("invalid rns bases")
            return r

        self.prod_B_mod_q = np.array(
            [self.base_B.base_prod % m.value for m in q.base], dtype=np.uint64
        )
        self.inv_prod_q_mod_Bsk = np.array(
            [inv_mod(q.base_prod, m) for m in self.base_Bsk.base], dtype=np.uint64
        )
        self.inv_prod_B_mod_m_sk = inv_mod(self.base_B.base_prod, self.m_sk)
        self.inv_m_tilde_mod_Bsk = np.array(
            [inv_mod(self.m_tilde.value, m) for m in self.base_Bsk.base],
            dtype=np.uint64,
        )
        self.inv_prod_q_mod_m_tilde = inv_mod(q.base_prod, self.m_tilde)
        self.prod_q_mod_Bsk = np.array(
            [q.base_prod % m.value for m in self.base_Bsk.base], dtype=np.uint64
        )

        if self.base_t_gamma is not None:
            self.inv_gamma_mod_t = inv_mod(self.gamma.value, t)
            self.prod_t_gamma_mod_q = np.array(
                [(t.value * self.gamma.value) % m.value for m in q.base],
                dtype=np.uint64,
            )
            self.neg_inv_q_mod_t_gamma = np.array(
                [
                    (-inv_mod(q.base_prod, m)) % m.value
                    for m in self.base_t_gamma.base
                ],
                dtype=np.uint64,
            )

        # q_last^{-1} mod q_i, for rescale / modulus switching (rns.cpp:719-729)
        q_last = q[base_q_size - 1].value
        self.inv_q_last_mod_q = np.array(
            [inv_mod(q_last, q[i]) for i in range(base_q_size - 1)], dtype=np.uint64
        )
