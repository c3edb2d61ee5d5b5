"""Exact-integer number theory (host side).

Copy of gemini_seal_tpu.utils.numth, the reference's number-theory layer
(reference: native/src/seal/util/numth.{h,cpp}).  Everything here runs at
context-build time with arbitrary-precision Python ints, producing the
precomputed constant tables that the device kernels consume.  Nothing in this
module touches torch.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "is_prime",
    "get_primes",
    "get_prime",
    "try_primitive_root",
    "try_minimal_primitive_root",
    "try_invert_uint_mod",
    "exponentiate_uint_mod",
    "naf",
    "gcd",
    "xgcd",
    "are_coprime",
    "reverse_bits",
    "get_power_of_two",
    "get_significant_bit_count",
]

# Deterministic Miller-Rabin witnesses: exact for all n < 2^64
# (Sorenson & Webster).  The reference uses 40 random-base rounds
# (numth.cpp:179-276); a deterministic witness set gives the same verdict for
# every 64-bit input with zero error probability.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def get_significant_bit_count(value: int) -> int:
    """Number of significant bits (reference: util/uintcore.h)."""
    return value.bit_length()


def get_power_of_two(value: int) -> int:
    """log2(value) if value is a power of two, else -1."""
    if value <= 0 or value & (value - 1):
        return -1
    return value.bit_length() - 1


def reverse_bits(operand: int, bit_count: int) -> int:
    """Reverse the low `bit_count` bits of operand (reference: uintcore.h)."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (operand & 1)
        operand >>= 1
    return result


def gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def xgcd(x: int, y: int) -> Tuple[int, int, int]:
    """Extended GCD: returns (g, a, b) with a*x + b*y = g.

    Matches the reference's xgcd (numth.cpp) sign conventions.
    """
    prev_a, a = 1, 0
    prev_b, b = 0, 1
    while y != 0:
        q = x // y
        x, y = y, x - q * y
        prev_a, a = a, prev_a - q * a
        prev_b, b = b, prev_b - q * b
    return x, prev_a, prev_b


def are_coprime(a: int, b: int) -> bool:
    return gcd(a, b) == 1


def try_invert_uint_mod(value: int, modulus: int):
    """Modular inverse; returns None when no inverse exists."""
    value %= modulus
    if value == 0:
        return None
    g, a, _ = xgcd(value, modulus)
    if g != 1:
        return None
    return a % modulus


def exponentiate_uint_mod(operand: int, exponent: int, modulus: int) -> int:
    return pow(operand, exponent, modulus)


def is_prime(value: int) -> bool:
    """Deterministic Miller-Rabin, exact for 64-bit inputs."""
    if value < 2:
        return False
    for p in _MR_WITNESSES:
        if value == p:
            return True
        if value % p == 0:
            return False
    d = value - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, value)
        if x == 1 or x == value - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % value
            if x == value - 1:
                break
        else:
            return False
    return True


def get_primes(ntt_size: int, bit_size: int, count: int) -> List[int]:
    """Generate `count` primes ≡ 1 (mod 2*ntt_size) below 2^bit_size.

    Mirrors the reference's descending-scan order (numth.cpp:277-323) so the
    returned primes are identical to `CoeffModulus::Create`'s choices.
    """
    if count <= 0:
        raise ValueError("count must be positive")
    if get_power_of_two(ntt_size) < 0:
        raise ValueError("ntt_size must be a power of two")
    if bit_size >= 63 or bit_size <= 1:
        raise ValueError("bit_size is invalid")
    factor = 2 * ntt_size
    value = (1 << bit_size) - factor + 1
    lower_bound = 1 << (bit_size - 1)
    result: List[int] = []
    while count > 0 and value > lower_bound:
        if is_prime(value):
            result.append(value)
            count -= 1
        value -= factor
    if count > 0:
        raise RuntimeError("failed to find enough qualifying primes")
    return result


def get_prime(ntt_size: int, bit_size: int) -> int:
    return get_primes(ntt_size, bit_size, 1)[0]


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """root is a primitive degree-th root of unity mod modulus (degree = 2^k).

    It suffices that root^(degree/2) == -1 (reference: numth.cpp:325-350).
    """
    if root == 0:
        return False
    return pow(root, degree >> 1, modulus) == modulus - 1


def try_primitive_root(degree: int, modulus: int):
    """Find some primitive degree-th root of unity mod modulus, or None.

    Unlike the reference (numth.cpp:352-396, which draws random candidates
    from std::random_device), this is deterministic: scan small candidates.
    Only an intermediate for try_minimal_primitive_root, whose result is
    canonical regardless of the starting root.
    """
    group_size = modulus - 1
    quotient_size = group_size // degree
    if group_size != quotient_size * degree:
        return None
    for candidate in range(2, min(modulus, 1 << 20)):
        root = pow(candidate, quotient_size, modulus)
        if is_primitive_root(root, degree, modulus):
            return root
    return None


def try_minimal_primitive_root(degree: int, modulus: int):
    """Smallest primitive degree-th root of unity mod modulus, or None.

    Same minimisation walk as the reference (numth.cpp:398-432): the set of
    primitive degree-th roots is {root * (root^2)^k}, walk it and keep the min.
    """
    root = try_primitive_root(degree, modulus)
    if root is None:
        return None
    generator_sq = (root * root) % modulus
    current = root
    best = root
    for _ in range(degree // 2 - 1):
        current = (current * generator_sq) % modulus
        if current < best:
            best = current
    return best


def naf(value: int) -> List[int]:
    """Non-adjacent form of a signed integer (reference: numth.cpp naf()).

    Returns the list of signed power-of-two terms whose sum is `value`,
    in the reference's emission order (low bits first, oddness-driven).
    """
    res: List[int] = []
    sign = -1 if value < 0 else 1
    value = abs(value)
    i = 0
    while value:
        if value & 1:
            zi = 2 - (value & 3)  # +1 if value % 4 == 1, -1 if == 3
            value -= zi
            res.append(sign * zi * (1 << i))
        value >>= 1
        i += 1
    return res
