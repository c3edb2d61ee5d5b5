"""BigUInt: arbitrary-width unsigned integer (reference: native/src/seal/
biguint.{h,cpp}, 2039 LoC of u64-limb arithmetic).

The reference hand-rolls limb arithmetic because C++ lacks big integers;
Python's int is exact and unbounded, so this class is a thin shell that
preserves the reference's API surface — explicit bit width, hex I/O,
operator overloads that wrap modulo 2^bit_count, and the save/load wire
format (an IntArray of u64 limbs).

Copy of gemini_seal_tpu/biguint.py: pure Python ints, no device data.
"""

from __future__ import annotations

import struct

__all__ = ["BigUInt"]


class BigUInt:
    def __init__(self, value=0, bit_count: int = None):
        """BigUInt(int), BigUInt(hex_str), or BigUInt(value, bit_count).

        Like the reference (biguint.h ctor overloads), a hex string sets the
        width to the significant bit count unless one is given explicitly.
        """
        if isinstance(value, str):
            v = int(value, 16) if value else 0
        elif isinstance(value, BigUInt):
            v = value._value
        else:
            v = int(value)
        if v < 0:
            raise ValueError("BigUInt is unsigned")
        self._bit_count = int(bit_count) if bit_count is not None else max(
            v.bit_length(), 0
        )
        if v.bit_length() > self._bit_count:
            raise ValueError("value does not fit in bit_count bits")
        self._value = v

    # -- reference accessors (biguint.h) ---------------------------------
    @property
    def bit_count(self) -> int:
        return self._bit_count

    @property
    def uint64_count(self) -> int:
        return (self._bit_count + 63) // 64

    @property
    def byte_count(self) -> int:
        return (self._bit_count + 7) // 8

    def significant_bit_count(self) -> int:
        return self._value.bit_length()

    def is_zero(self) -> bool:
        return self._value == 0

    def to_string(self) -> str:
        """Uppercase hex, no leading zeros (biguint.cpp to_string)."""
        return format(self._value, "X") if self._value else "0"

    to_hex = to_string

    def to_dec_string(self) -> str:
        return str(self._value)

    def __int__(self) -> int:
        return self._value

    def resize(self, bit_count: int) -> None:
        mask = (1 << bit_count) - 1
        self._value &= mask
        self._bit_count = bit_count

    def set_zero(self) -> None:
        self._value = 0

    # -- operators (wrap modulo 2^bit_count like the reference) ----------
    def _wrap(self, v: int, other=None) -> "BigUInt":
        bits = max(self._bit_count, other._bit_count if isinstance(other, BigUInt) else 0)
        bits = max(bits, 1)
        return BigUInt(v & ((1 << bits) - 1), bits)

    @staticmethod
    def _val(x) -> int:
        return x._value if isinstance(x, BigUInt) else int(x)

    def __add__(self, o):
        return self._wrap(self._value + self._val(o), o if isinstance(o, BigUInt) else None)

    def __sub__(self, o):
        return self._wrap(self._value - self._val(o), o if isinstance(o, BigUInt) else None)

    def __mul__(self, o):
        return self._wrap(self._value * self._val(o), o if isinstance(o, BigUInt) else None)

    def __floordiv__(self, o):
        return self._wrap(self._value // self._val(o), o if isinstance(o, BigUInt) else None)

    def __mod__(self, o):
        return self._wrap(self._value % self._val(o), o if isinstance(o, BigUInt) else None)

    def __xor__(self, o):
        return self._wrap(self._value ^ self._val(o), o if isinstance(o, BigUInt) else None)

    def __and__(self, o):
        return self._wrap(self._value & self._val(o), o if isinstance(o, BigUInt) else None)

    def __or__(self, o):
        return self._wrap(self._value | self._val(o), o if isinstance(o, BigUInt) else None)

    def __lshift__(self, n: int):
        return self._wrap(self._value << n)

    def __rshift__(self, n: int):
        return BigUInt(self._value >> n, self._bit_count)

    def __eq__(self, o) -> bool:
        return self._value == self._val(o)

    def __lt__(self, o) -> bool:
        return self._value < self._val(o)

    def __le__(self, o) -> bool:
        return self._value <= self._val(o)

    def __hash__(self):
        return hash(self._value)

    def __repr__(self):
        return f"BigUInt({self.to_string()!r}, bit_count={self._bit_count})"

    def divrem(self, o):
        """(quotient, remainder) (biguint divrem)."""
        d = self._val(o)
        return self._wrap(self._value // d), self._wrap(self._value % d)

    def modinv(self, modulus) -> "BigUInt":
        m = self._val(modulus)
        return BigUInt(pow(self._value, -1, m))

    def trypow(self, exponent: int, modulus) -> "BigUInt":
        return BigUInt(pow(self._value, exponent, self._val(modulus)))

    # -- wire format: u64 limbs, little-endian (IntArray save) -----------
    def save(self) -> bytes:
        limbs = self.uint64_count
        out = bytearray()
        v = self._value
        for _ in range(limbs):
            out += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)
            v >>= 64
        return bytes(out)

    @staticmethod
    def load(data: bytes, bit_count: int) -> "BigUInt":
        limbs = (bit_count + 63) // 64
        v = 0
        for i in range(limbs):
            (w,) = struct.unpack_from("<Q", data, 8 * i)
            v |= w << (64 * i)
        return BigUInt(v & ((1 << bit_count) - 1), bit_count)
