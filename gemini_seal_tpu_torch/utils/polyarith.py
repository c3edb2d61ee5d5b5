"""Generic (multiprecision-coefficient) polynomial arithmetic.

Rework of the reference's legacy big-coefficient poly layer
(reference: native/src/seal/util/polyarith.{h,cpp}, 378 LoC): polynomials
whose coefficients are arbitrary-width unsigned integers stored as
multi-uint64 words.  The reference walks word arrays with carries; here a
polynomial is simply a list of Python ints (exact bignums) — the entire
word-level machinery (uintarith add/sub/multiply with carry chains)
collapses into `int` arithmetic, which is the idiomatic host-plane
representation used throughout this build (SURVEY L0 mapping).

These ops are host-plane utilities (the hot RNS ops live in ops/); they
back BigUInt-coefficient workflows and the big-poly tests mirroring
tests/seal/util/polyarith.cpp.

Copy of gemini_seal_tpu/utils/polyarith.py: pure Python ints, no device
data.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = [
    "right_shift_poly_coeffs",
    "negate_poly",
    "add_poly",
    "sub_poly",
    "multiply_poly",
    "poly_infty_norm",
    "poly_eval_poly",
]


def _mask(coeff_bit_count: int) -> int:
    return (1 << coeff_bit_count) - 1


def right_shift_poly_coeffs(poly: Sequence[int], shift_amount: int) -> List[int]:
    """Per-coefficient logical right shift (polyarith.h:17-33)."""
    if shift_amount < 0:
        raise ValueError("shift_amount must be non-negative")
    return [int(c) >> shift_amount for c in poly]


def negate_poly(poly: Sequence[int], coeff_bit_count: int) -> List[int]:
    """Two's-complement negation per coefficient at a fixed width
    (polyarith.h:35-54)."""
    m = _mask(coeff_bit_count)
    return [(-int(c)) & m for c in poly]


def add_poly(a: Sequence[int], b: Sequence[int], coeff_bit_count: int) -> List[int]:
    """Coefficient-wise addition, wrapping at the word width
    (polyarith.h:56-81; the reference discards the final carry)."""
    m = _mask(coeff_bit_count)
    n = max(len(a), len(b))
    ap = list(a) + [0] * (n - len(a))
    bp = list(b) + [0] * (n - len(b))
    return [(int(x) + int(y)) & m for x, y in zip(ap, bp)]


def sub_poly(a: Sequence[int], b: Sequence[int], coeff_bit_count: int) -> List[int]:
    """Coefficient-wise subtraction, two's-complement wrap
    (polyarith.h:83-108)."""
    m = _mask(coeff_bit_count)
    n = max(len(a), len(b))
    ap = list(a) + [0] * (n - len(a))
    bp = list(b) + [0] * (n - len(b))
    return [(int(x) - int(y)) & m for x, y in zip(ap, bp)]


def multiply_poly(a: Sequence[int], b: Sequence[int],
                  result_coeff_count: int = 0) -> List[int]:
    """Schoolbook polynomial product with exact big-int coefficients
    (polyarith.cpp:15-87 multiply_poly; no modulus, no wrap — the
    reference's result width is a caller concern, here ints are exact)."""
    if not a or not b:
        return [0] * (result_coeff_count or 1)
    n = len(a) + len(b) - 1
    out = [0] * n
    for i, ai in enumerate(a):
        ai = int(ai)
        if not ai:
            continue
        for j, bj in enumerate(b):
            out[i + j] += ai * int(bj)
    if result_coeff_count:
        out = (out + [0] * result_coeff_count)[:result_coeff_count]
    return out


def poly_infty_norm(poly: Sequence[int]) -> int:
    """max |c_i| treating coefficients as unsigned (polyarith.h:116-129)."""
    return max((int(c) for c in poly), default=0)


def poly_eval_poly(poly_to_eval: Sequence[int], value: Sequence[int]) -> List[int]:
    """Evaluate a polynomial at a polynomial (Horner over poly products;
    polyarith.cpp:89-236 poly_eval_poly), exact big-int coefficients."""
    result: List[int] = [0]
    for c in reversed([int(c) for c in poly_to_eval]):
        result = multiply_poly(result, value)    # r <- r * v
        if not result:
            result = [0]
        result[0] += c                           # r <- r + c  (Horner)
    while len(result) > 1 and result[-1] == 0:   # trim degree slack
        result.pop()
    return result
