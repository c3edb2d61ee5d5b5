"""Modulus and modulus factories (host side, exact ints).

Copy of gemini_seal_tpu.modulus, the reference's Modulus / CoeffModulus / PlainModulus
(reference: native/src/seal/modulus.{h,cpp}).  A :class:`Modulus` carries the
Barrett precompute ``const_ratio = floor(2^128 / value)`` split into two u64
words plus the remainder word — the exact triple the device kernels consume
(reference: modulus.h:122-129, modulus.cpp:66-105).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .utils import numth

__all__ = ["Modulus", "SecLevelType", "CoeffModulus", "PlainModulus"]

U64 = 0xFFFFFFFFFFFFFFFF

# Bounds (reference: util/defines.h:33-58; fork-tightened values)
MOD_BIT_COUNT_MAX = 61
MOD_BIT_COUNT_MIN = 2
USER_MOD_BIT_COUNT_MAX = 59
USER_MOD_BIT_COUNT_MIN = 2
PLAIN_MOD_BIT_COUNT_MAX = USER_MOD_BIT_COUNT_MAX
PLAIN_MOD_BIT_COUNT_MIN = USER_MOD_BIT_COUNT_MIN
COEFF_MOD_COUNT_MAX = 64
COEFF_MOD_COUNT_MIN = 1
POLY_MOD_DEGREE_MAX = 65536
POLY_MOD_DEGREE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16
CIPHERTEXT_SIZE_MIN = 2


class SecLevelType(enum.IntEnum):
    """Security levels per HomomorphicEncryption.org (reference: modulus.h)."""

    none = 0
    tc128 = 128
    tc192 = 192
    tc256 = 256


@dataclass(frozen=True)
class Modulus:
    """An up-to-61-bit modulus with its Barrett precompute.

    ``const_ratio`` is (lo, hi, remainder) of floor(2^128/value)
    (reference: modulus.cpp:66-105).
    """

    value: int
    bit_count: int = field(init=False)
    const_ratio: Tuple[int, int, int] = field(init=False)
    is_prime: bool = field(init=False)

    def __post_init__(self):
        v = int(self.value)
        if v == 0:
            object.__setattr__(self, "bit_count", 0)
            object.__setattr__(self, "const_ratio", (0, 0, 0))
            object.__setattr__(self, "is_prime", False)
            return
        if v >> MOD_BIT_COUNT_MAX or v.bit_length() < MOD_BIT_COUNT_MIN:
            raise ValueError(f"modulus value {v} out of [2, 2^61) range")
        object.__setattr__(self, "value", v)
        object.__setattr__(self, "bit_count", v.bit_length())
        quotient, rem = divmod(1 << 128, v)
        object.__setattr__(
            self, "const_ratio", (quotient & U64, (quotient >> 64) & U64, rem)
        )
        object.__setattr__(self, "is_prime", numth.is_prime(v))

    def is_zero(self) -> bool:
        return self.value == 0

    def reduce(self, x: int) -> int:
        return x % self.value

    def __int__(self) -> int:
        return self.value

    def __repr__(self) -> str:
        return f"Modulus({self.value:#x})"


# Curated default prime lists (reference: util/globals.cpp:23-160).  These are
# public parameter-set constants from the SEAL distribution, keyed by
# poly_modulus_degree.
_DEFAULT_COEFF_128: Dict[int, List[int]] = {
    1024: [0x7E00001],
    2048: [0x3FFFFFFF000001],
    4096: [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001],
    8192: [0x7FFFFFD8001, 0x7FFFFFC8001, 0xFFFFFFFC001, 0xFFFFFF6C001, 0xFFFFFEBC001],
    16384: [
        0xFFFFFFFD8001, 0xFFFFFFFA0001, 0xFFFFFFF00001, 0x1FFFFFFF68001,
        0x1FFFFFFF50001, 0x1FFFFFFEE8001, 0x1FFFFFFEA0001, 0x1FFFFFFE88001,
        0x1FFFFFFE48001,
    ],
    32768: [
        0x7FFFFFFFE90001, 0x7FFFFFFFBF0001, 0x7FFFFFFFBD0001, 0x7FFFFFFFBA0001,
        0x7FFFFFFFAA0001, 0x7FFFFFFFA50001, 0x7FFFFFFF9F0001, 0x7FFFFFFF7E0001,
        0x7FFFFFFF770001, 0x7FFFFFFF380001, 0x7FFFFFFF330001, 0x7FFFFFFF2D0001,
        0x7FFFFFFF170001, 0x7FFFFFFF150001, 0x7FFFFFFEF00001, 0xFFFFFFFFF70001,
    ],
}

_DEFAULT_COEFF_192: Dict[int, List[int]] = {
    1024: [0x7F001],
    2048: [0x1FFFFC0001],
    4096: [0x1FFC001, 0x1FCE001, 0x1FC0001],
    8192: [0x3FFFFAC001, 0x3FFFF54001, 0x3FFFF48001, 0x3FFFF28001],
    16384: [
        0x3FFFFFFDF0001, 0x3FFFFFFD48001, 0x3FFFFFFD20001, 0x3FFFFFFD18001,
        0x3FFFFFFCD0001, 0x3FFFFFFC70001,
    ],
    32768: [
        0x3FFFFFFFD60001, 0x3FFFFFFFCA0001, 0x3FFFFFFF6D0001, 0x3FFFFFFF5D0001,
        0x3FFFFFFF550001, 0x7FFFFFFFE90001, 0x7FFFFFFFBF0001, 0x7FFFFFFFBD0001,
        0x7FFFFFFFBA0001, 0x7FFFFFFFAA0001, 0x7FFFFFFFA50001,
    ],
}

_DEFAULT_COEFF_256: Dict[int, List[int]] = {
    1024: [0x3001],
    2048: [0x1FFC0001],
    4096: [0x3FFFFFFFF040001],
    8192: [0x7FFFFEC001, 0x7FFFFB0001, 0xFFFFFDC001],
    16384: [0x7FFFFFFC8001, 0x7FFFFFF00001, 0x7FFFFFE70001, 0xFFFFFFFD8001, 0xFFFFFFFA0001],
    32768: [
        0xFFFFFFFF00001, 0x1FFFFFFFE30001, 0x1FFFFFFFD80001, 0x1FFFFFFFD10001,
        0x1FFFFFFFC50001, 0x1FFFFFFFBF0001, 0x1FFFFFFFB90001, 0x1FFFFFFFB60001,
        0x1FFFFFFFA50001,
    ],
}

# Max log2(q) per (N, security) for ternary secrets
# (reference: util/hestdparms.h:19-144).
_HE_STD_MAX_BITS = {
    SecLevelType.tc128: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881},
    SecLevelType.tc192: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611},
    SecLevelType.tc256: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476},
}

# QUANTUM-security budgets (reference: hestdparms.h:81-144,
# SEAL_HE_STD_PARMS_{128,192,256}_TQ).  Dead code upstream too: the public
# sec_level_type enum (reference modulus.h:383-401) exposes only the
# tc (classical) levels and nothing calls the _TQ functions — reproduced
# for full table parity and for callers that want to check a parameter
# set against the post-quantum budget by hand via
# CoeffModulus.max_bit_count_quantum.
_HE_STD_MAX_BITS_QUANTUM = {
    SecLevelType.tc128: {1024: 25, 2048: 51, 4096: 101, 8192: 202, 16384: 411, 32768: 827},
    SecLevelType.tc192: {1024: 17, 2048: 35, 4096: 70, 8192: 141, 16384: 284, 32768: 571},
    SecLevelType.tc256: {1024: 13, 2048: 27, 4096: 54, 8192: 109, 16384: 220, 32768: 443},
}

HE_STD_ERROR_STD_DEV = 3.20  # reference: hestdparms.h:145
NOISE_MAX_DEVIATION = HE_STD_ERROR_STD_DEV * 6  # reference: globals.h:38-42


class CoeffModulus:
    """Factories for coefficient modulus chains (reference: modulus.h:417-491)."""

    @staticmethod
    def max_bit_count(poly_modulus_degree: int, sec_level: SecLevelType = SecLevelType.tc128) -> int:
        if sec_level == SecLevelType.none:
            return 2**31 - 1
        return _HE_STD_MAX_BITS[sec_level].get(poly_modulus_degree, 0)

    # PEP8 alias kept next to the SEAL-style name for API parity
    MaxBitCount = max_bit_count

    @staticmethod
    def max_bit_count_quantum(
        poly_modulus_degree: int, sec_level: SecLevelType = SecLevelType.tc128
    ) -> int:
        """Post-quantum log2(q) budget (reference: hestdparms.h:81-144,
        *_TQ tables).  Not reachable through SEALContext validation — the
        reference's sec_level_type enum exposes only the classical levels
        and its _TQ functions are never called; provided for parity and
        manual parameter audits."""
        if sec_level == SecLevelType.none:
            return 2**31 - 1
        return _HE_STD_MAX_BITS_QUANTUM[sec_level].get(poly_modulus_degree, 0)

    @staticmethod
    def bfv_default(
        poly_modulus_degree: int, sec_level: SecLevelType = SecLevelType.tc128
    ) -> List[Modulus]:
        if not CoeffModulus.max_bit_count(poly_modulus_degree, sec_level):
            raise ValueError("non-standard poly_modulus_degree")
        if sec_level == SecLevelType.none:
            raise ValueError("invalid security level")
        table = {
            SecLevelType.tc128: _DEFAULT_COEFF_128,
            SecLevelType.tc192: _DEFAULT_COEFF_192,
            SecLevelType.tc256: _DEFAULT_COEFF_256,
        }[sec_level]
        return [Modulus(v) for v in table[poly_modulus_degree]]

    BFVDefault = bfv_default

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: Sequence[int]) -> List[Modulus]:
        """Distinct primes ≡ 1 mod 2N with the requested bit sizes.

        Matches the reference's allocation order exactly: per distinct bit
        size, generate count primes descending, then hand them out back-to-
        front in the order requested (reference: modulus.cpp:134-173).
        """
        if (
            poly_modulus_degree > POLY_MOD_DEGREE_MAX
            or poly_modulus_degree < POLY_MOD_DEGREE_MIN
            or numth.get_power_of_two(poly_modulus_degree) < 0
        ):
            raise ValueError("poly_modulus_degree is invalid")
        if len(bit_sizes) > COEFF_MOD_COUNT_MAX:
            raise ValueError("bit_sizes is invalid")
        if bit_sizes and (
            max(bit_sizes) > USER_MOD_BIT_COUNT_MAX or min(bit_sizes) < USER_MOD_BIT_COUNT_MIN
        ):
            raise ValueError("bit_sizes is invalid")

        count_table: Dict[int, int] = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        prime_table = {
            size: numth.get_primes(poly_modulus_degree, size, count)
            for size, count in count_table.items()
        }
        result = []
        for size in bit_sizes:
            result.append(Modulus(prime_table[size].pop()))
        return result

    Create = create


class PlainModulus:
    """Factories for batching-capable plaintext moduli (reference: modulus.h:496-537)."""

    @staticmethod
    def batching(poly_modulus_degree: int, bit_size) -> "Modulus | List[Modulus]":
        if isinstance(bit_size, int):
            return CoeffModulus.create(poly_modulus_degree, [bit_size])[0]
        return CoeffModulus.create(poly_modulus_degree, list(bit_size))

    Batching = batching
