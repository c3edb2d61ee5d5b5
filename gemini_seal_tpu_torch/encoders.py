"""Encoders: BFV SIMD batching and the CKKS canonical embedding
(reference: batchencoder.{h,cpp}, ckks.{h,cpp}, util/croots.{h,cpp}).

Port of gemini_seal_tpu/encoders.py.  BatchEncoder: the 2 x (N/2) slot
matrix through the generator-5 index map and the negacyclic NTT mod t
(one ``ntt`` launch over one limb).  CKKSEncoder: the vector encode and
decode with the generator-5 slot map and the high-precision 2N-th complex
roots (8-fold symmetry); the embedding FFT runs vectorized on the host in
float64, the NTT on the context's device.  Rounding (half away from zero)
and the exact RNS decomposition and CRT decode ladder match the reference
bit for bit.  A CKKS scalar encodes as the constant polynomial: its
residues broadcast across N are already its NTT form (no transform); a
non-finite scalar raises (the JAX package lets an infinite value*scale
through its size check).  The IntegerEncoder comes with a later slice.
"""

from __future__ import annotations

import cmath
import math
from typing import List, Sequence

import numpy as np
import torch

from .ciphertext import Plaintext
from .context import SealContext
from .ops.backend import to_numpy, to_tensor
from .ops.ntt import ntt_forward, ntt_inverse
from .params import SchemeType
from .utils import mplimb, numth

__all__ = ["BatchEncoder", "CKKSEncoder", "ComplexRoots"]


class ComplexRoots:
    """High-precision 2N-th complex roots with 8-fold symmetry
    (reference: util/croots.cpp)."""

    PI = 3.1415926535897932384626433832795028842

    def __init__(self, degree_of_roots: int):
        self.degree = degree_of_roots
        # 1/8 of the circle, exactly as the reference generates them.
        self._roots = [
            cmath.rect(1.0, 2 * self.PI * i / degree_of_roots)
            for i in range(degree_of_roots // 8 + 1)
        ]

    def get_root(self, index: int) -> complex:
        index &= self.degree - 1
        d = self.degree
        if index <= d // 8:
            return self._roots[index]
        if index <= d // 4:
            r = self._roots[d // 4 - index]
            return complex(r.imag, r.real)
        if index <= d // 2:
            return -self.get_root(d // 2 - index).conjugate()
        if index <= 3 * d // 4:
            return -self.get_root(index - d // 2)
        return self.get_root(d - index).conjugate()


def _slot_index_map(n: int, generator: int) -> np.ndarray:
    """The 2 x (n/2) slot matrix map, bit-reversed: slot i of the first row
    and of the second sit at the NTT positions of generator^i and its
    negation (batchencoder.cpp:69-91, ckks.cpp:37-56)."""
    logn = numth.get_power_of_two(n)
    row_size = n >> 1
    m = n << 1
    pos = 1
    index_map = np.zeros(n, dtype=np.int64)
    for i in range(row_size):
        index_map[i] = numth.reverse_bits((pos - 1) >> 1, logn)
        index_map[row_size | i] = numth.reverse_bits((m - pos - 1) >> 1, logn)
        pos = (pos * generator) & (m - 1)
    return index_map


class BatchEncoder:
    """BFV SIMD slots (reference: batchencoder.cpp).

    compat_gen3=True gives the reference's generator-3 index map
    (batchencoder.cpp:77-91), whose slot order interoperates with the
    reference's plaintexts; the default generator-5 map matches the fork's
    GaloisTool (galois.h:169), so that rotations permute slots as rows and
    columns (the JAX package's README, deviation #2).  Plaintexts hold
    int64[N] coefficients on the context's device.
    """

    def __init__(self, context: SealContext, compat_gen3: bool = False, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.device = context.check_device(device)
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        if not cd.qualifiers.using_batching:
            raise ValueError("encryption parameters are not valid for batching")
        self.context = context
        self.slots = cd.parms.poly_modulus_degree
        self.generator = 3 if compat_gen3 else 5
        self._index_map = _slot_index_map(self.slots, self.generator)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _slot_row(self, values, t: int) -> np.ndarray:
        """Slot values -> the NTT-domain row mod t (values in [-t, t))."""
        try:
            vals = np.asarray(list(values), dtype=np.int64)
        except OverflowError:
            raise ValueError("input value is larger than plain_modulus")
        if vals.size > self.slots:
            raise ValueError("values_matrix size is too large")
        if vals.size and (int(vals.min()) < -t or int(vals.max()) >= t):
            raise ValueError("input value is larger than plain_modulus")
        vals = np.where(vals < 0, vals + t, vals).astype(np.uint64)
        dest = np.zeros(self.slots, dtype=np.uint64)
        dest[self._index_map[: vals.size]] = vals
        return dest

    def encode(self, values: Sequence[int]) -> Plaintext:
        """uint64/int64 slot values -> plaintext poly
        (batchencoder.cpp:115-198)."""
        return self.encode_batch([values])[0]

    def encode_batch(self, values_list) -> List[Plaintext]:
        """Encode many slot-value vectors with one inverse NTT over the
        [B, 1, N] stack (identical Plaintexts to per-vector encode)."""
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        rows = [self._slot_row(values, t) for values in values_list]
        if not rows:
            return []
        out = ntt_inverse(to_tensor(np.stack(rows)[:, None, :], self.device),
                          cd.plain_ntt_tables)
        return [Plaintext(data=out[b, 0]) for b in range(len(rows))]

    def decode(self, plain: Plaintext, signed: bool = False) -> List[int]:
        """plaintext poly -> slot values (batchencoder.cpp:339-420)."""
        return self.decode_batch([plain], signed)[0]

    def decode_batch(self, plains, signed: bool = False) -> List[List[int]]:
        """Decode many plaintexts with one forward NTT (identical values to
        per-plaintext decode)."""
        ps = list(plains)
        if not ps:
            return []
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        temp = torch.zeros((len(ps), 1, self.slots), dtype=torch.int64, device=self.device)
        for b, p_ in enumerate(ps):
            if p_.is_ntt_form:
                raise ValueError("plain cannot be in NTT form")
            count = min(p_.data.shape[0], self.slots)
            temp[b, 0, :count] = p_.data[:count]
        vals = to_numpy(ntt_forward(temp, cd.plain_ntt_tables))[:, 0, :]
        out = vals[:, self._index_map].astype(np.int64)
        if signed:
            half = t >> 1
            out = np.where(out > half, out - t, out)
        return [[int(v) for v in row] for row in out]


class CKKSEncoder:
    """CKKS canonical embedding (reference: ckks.{h,cpp})."""

    def __init__(self, context: SealContext, device=None):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.device = context.check_device(device)
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        self.context = context
        n = cd.parms.poly_modulus_degree
        self.slots = n >> 1
        logn = numth.get_power_of_two(n)
        self._logn = logn
        self._n = n

        self._index_map = _slot_index_map(n, 5)  # ckks.cpp:37-56
        m = n << 1

        # bit-reversed root tables (ckks.cpp:58-77)
        roots = np.zeros(n, dtype=np.complex128)
        if m >= 8:
            croots = ComplexRoots(m)
            for i in range(n):
                roots[i] = croots.get_root(numth.reverse_bits(i, logn))
        elif m == 4:
            roots[0] = 1j
            roots[1] = -1j
        self._roots = roots
        self._inv_roots = np.conj(roots)

    @property
    def slot_count(self) -> int:
        return self.slots

    # -- embedding FFTs (vectorized versions of ckks.h:458-482, 723-744;
    #    batch-polymorphic over leading axes) --
    def _embedding_inverse(self, a: np.ndarray) -> np.ndarray:
        n = self._n
        logn = self._logn
        batch = a.shape[:-1]
        tt = 1
        for i in range(logn):
            mm = 1 << (logn - i)
            h = mm >> 1
            s = self._inv_roots[h : 2 * h][:, None]       # [h, 1]
            a = a.reshape(batch + (h, 2, tt))
            u = a[..., 0, :]
            v = a[..., 1, :]
            a = np.stack([u + v, (u - v) * s], axis=-2).reshape(batch + (n,))
            tt <<= 1
        return a

    def _embedding_forward(self, a: np.ndarray) -> np.ndarray:
        n = self._n
        logn = self._logn
        batch = a.shape[:-1]
        tt = n
        for i in range(logn):
            mm = 1 << i
            tt >>= 1
            s = self._roots[mm : 2 * mm][:, None]
            a = a.reshape(batch + (mm, 2, tt))
            u = a[..., 0, :]
            v = a[..., 1, :] * s
            a = np.stack([u + v, u - v], axis=-2).reshape(batch + (n,))
        return a

    # -- encode ----------------------------------------------------------
    def encode(self, values, scale: float, parms_id=None) -> Plaintext:
        """values (<= N/2 slots of double/complex, or one real or complex
        scalar for every slot) -> NTT-form RNS plaintext on the context's
        device (reference: ckks.h:405-617)."""
        if parms_id is None:
            parms_id = self.context.first_parms_id
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        if isinstance(values, (int, float)):
            return self._encode_scalar(float(values), scale, cd)
        if isinstance(values, complex):
            values = [values] * self.slots
        n = self._n
        values = list(values)
        if len(values) > self.slots:
            raise ValueError("values_size is too large")
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

        vals_arr = np.asarray(values, dtype=np.complex128)
        conj_values = np.zeros(n, dtype=np.complex128)
        conj_values[self._index_map[: vals_arr.size]] = vals_arr
        conj_values[self._index_map[self.slots : self.slots + vals_arr.size]] = (
            np.conj(vals_arr)
        )

        conj_values = self._embedding_inverse(conj_values)
        n_inv = (1.0 / n) * scale
        conj_values *= n_inv

        reals = conj_values.real
        d = np.maximum(np.abs(reals), 1.0)
        max_coeff_bit_count = int(np.max(np.floor(np.log2(d)))) + 2
        if max_coeff_bit_count >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded values are too large")

        rounded = np.sign(reals) * np.floor(np.abs(reals) + 0.5)
        dest = self._decompose_exact(rounded, cd.parms.coeff_modulus)
        out = ntt_forward(to_tensor(dest, self.device), cd.ntt_tables)
        return Plaintext(data=out, parms_id=cd.parms_id, scale=scale)

    def _encode_scalar(self, value: float, scale: float, cd) -> Plaintext:
        """Constant encode: all slots equal -> constant polynomial
        (reference: ckks.cpp:80-230), whose NTT form is its residues
        broadcast across N (ckks.cpp:128-214 fill_n's them, no transform)."""
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")
        coeffd = value * scale
        if not math.isfinite(coeffd):
            raise ValueError("encoded value is not finite")
        # compare in bit space: 2.0**bits overflows float64 past 1024 bits
        if (coeffd != 0.0 and math.frexp(abs(coeffd))[1]
                > cd.total_coeff_modulus_bit_count):
            raise ValueError("encoded value is too large")
        rounded = math.copysign(math.floor(abs(coeffd) + 0.5), coeffd)
        res = self._decompose_exact(np.array([rounded], dtype=np.float64),
                                    cd.parms.coeff_modulus)  # [L, 1]
        out = to_tensor(np.broadcast_to(res, (res.shape[0], self._n)), self.device)
        return Plaintext(data=out, parms_id=cd.parms_id, scale=scale)

    @staticmethod
    def _decompose_exact(rounded: np.ndarray, moduli) -> np.ndarray:
        """Exact RNS residues of already-rounded (integer-valued) doubles:
        below 2^62 through an exact float->int64 cast, above through the
        exact mantissa/exponent split (a rounded double IS m * 2^e with a
        53-bit integer mantissa) on Python ints."""
        L = len(moduli)
        dest = np.zeros((L, rounded.shape[0]), dtype=np.uint64)
        small = np.abs(rounded) < 2.0 ** 62
        as_int = np.where(small, rounded, 0.0).astype(np.int64)
        for j, mod in enumerate(moduli):
            dest[j] = np.mod(as_int, np.int64(mod.value)).astype(np.uint64)
        for i in np.nonzero(~small)[0]:
            v = int(rounded[i])  # exact: the double is an integer
            for j, mod in enumerate(moduli):
                dest[j, i] = v % mod.value
        return dest

    # -- decode ----------------------------------------------------------
    def decode(self, plain: Plaintext, as_complex: bool = False):
        """NTT-form RNS plaintext -> slot values (reference: ckks.h:620-750)."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        if plain.scale <= 0 or int(math.log2(plain.scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

        inv_scale = 1.0 / plain.scale
        data = to_numpy(ntt_inverse(plain.data.to(self.device), cd.ntt_tables))
        res_real = self._centered_ladder(data, cd, inv_scale)
        res = self._embedding_forward(res_real.astype(np.complex128))
        out_arr = res[self._index_map[: self.slots]]
        if as_complex:
            return out_arr.tolist()
        return out_arr.real.tolist()

    @staticmethod
    def _centered_ladder(data: np.ndarray, cd, inv_scale: float) -> np.ndarray:
        """CRT-compose [L, M] residue planes to centered doubles [M]
        (reference: ckks.h:668-744): v >= (q+1)/2 decodes as -(q - v); the
        LSB-first double ladder keeps the reference's op order, and
        negating the positive-ladder result is bit-exact to the reference's
        subtract-each-term order (IEEE rounding is sign-symmetric)."""
        q = cd.total_coeff_modulus
        K = max(1, (q.bit_length() + 63) // 64)
        upper = cd.upper_half_threshold
        vals = mplimb.compose_ints(data, cd.rns_base)
        is_neg = np.array([v >= upper for v in vals], dtype=bool)
        mag = mplimb.ints_to_limbs([q - v if v >= upper else v for v in vals], K)
        res_real = mplimb.ladder_to_double(mag, inv_scale)
        return np.where(is_neg, -res_real, res_real)
