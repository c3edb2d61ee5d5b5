"""PRNG factory and RLWE samplers (host side).

Copy of gemini_seal_tpu.utils.prng, the reference's randomness stack
(reference: native/src/seal/randomgen.{h,cpp}, randomtostd.h,
util/rlwe.cpp:21-129, util/clipnormal.{h,cpp}).  The byte stream is the
bit-exact Blake2xbPRNG from :mod:`.blake2`; the three samplers reproduce the
reference's draw order *including* the libstdc++ distribution algorithms it
inherits (uniform_int_distribution's down-scaling rejection and
normal_distribution's Marsaglia polar method), so seeded outputs can be
cross-checked byte-for-byte against the compiled C++ reference.

Sampling is a host-side boundary: keys/encryptions draw little randomness
relative to the ciphertext compute, and exact IEEE-double semantics (the
polar method) stay on the host.  Outputs land as numpy [L, N] residue
planes ready for upload to the device.
"""

from __future__ import annotations

import math
import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from .blake2 import Blake2xbPRNG

__all__ = [
    "BlakePRNGFactory",
    "random_seed",
    "StdNormalDistribution",
    "sample_poly_ternary",
    "sample_poly_normal",
    "sample_poly_uniform",
    "NOISE_STANDARD_DEVIATION",
    "NOISE_MAX_DEVIATION",
]

NOISE_STANDARD_DEVIATION = 3.20          # hestdparms.h:145
NOISE_MAX_DEVIATION = 6 * 3.20           # globals.h:38-42


def random_seed() -> tuple:
    """Fresh 8-word seed from system entropy (randomgen.cpp:18-36)."""
    return tuple(struct.unpack("<8Q", os.urandom(64)))


class BlakePRNGFactory:
    """UniformRandomGeneratorFactory with blake2xb streams
    (randomgen.h:222-260)."""

    def __init__(self, default_seed: Optional[Sequence[int]] = None):
        self.default_seed = tuple(default_seed) if default_seed is not None else None

    def create(self, seed: Optional[Sequence[int]] = None) -> Blake2xbPRNG:
        if seed is None:
            seed = self.default_seed if self.default_seed is not None else random_seed()
        return Blake2xbPRNG(seed)


class StdNormalDistribution:
    """libstdc++-compatible std::normal_distribution<double>.

    Marsaglia polar method over generate_canonical<double, 53> with a
    32-bit URBG (two draws per canonical).  Stateful: the spare variate is
    saved across calls, exactly as libstdc++ does.
    """

    def __init__(self, mean: float = 0.0, stddev: float = 1.0):
        self.mean = mean
        self.stddev = stddev
        self._saved: Optional[float] = None

    def _canonical(self, engine) -> float:
        # generate_canonical<double, 53 bits> with r = 2^32 -> 2 draws.
        d0 = float(engine.draw_u32())
        d1 = float(engine.draw_u32())
        ret = (d0 + d1 * 4294967296.0) / 18446744073709551616.0
        if ret >= 1.0:
            ret = math.nextafter(1.0, 0.0)
        return ret

    def __call__(self, engine) -> float:
        if self._saved is not None:
            ret = self._saved
            self._saved = None
        else:
            while True:
                x = 2.0 * self._canonical(engine) - 1.0
                y = 2.0 * self._canonical(engine) - 1.0
                r2 = x * x + y * y
                if r2 <= 1.0 and r2 != 0.0:
                    break
            mult = math.sqrt(-2.0 * math.log(r2) / r2)
            self._saved = x * mult
            ret = y * mult
        return ret * self.stddev + self.mean


def sample_poly_ternary(prng: Blake2xbPRNG, moduli: Sequence[int], n: int) -> np.ndarray:
    """Ternary {-1, 0, 1} poly as [L, N] residues (rlwe.cpp:21-55).

    One uniform_int_distribution<int>(-1, 1) draw per coefficient:
    libstdc++ down-scales a 32-bit draw by (2^32-1)/3, rejecting the single
    value 2^32-1.
    """
    scaling = 1431655765  # (2^32 - 1) // 3
    draws = prng.draw_u32_array(n).astype(np.int64)
    bad = np.nonzero(draws == 4294967295)[0]
    for idx in bad:  # rejection probability 2^-32; redraws are sequential
        d = prng.draw_u32()
        while d == 4294967295:
            d = prng.draw_u32()
        draws[idx] = d
    vals = draws // scaling - 1  # in {-1, 0, 1}
    out = np.zeros((len(moduli), n), dtype=np.uint64)
    for j, q in enumerate(moduli):
        row = out[j]
        row[vals == 1] = 1
        row[vals == -1] = np.uint64(q - 1)
    return out


def sample_poly_normal(prng: Blake2xbPRNG, moduli: Sequence[int], n: int) -> np.ndarray:
    """Clipped Gaussian noise poly as [L, N] residues (rlwe.cpp:57-99).

    ClippedNormalDistribution(0, 3.2, 19.2) (clipnormal.h): resample until
    |x| <= 6 sigma, then truncate toward zero to int64.
    """
    if NOISE_MAX_DEVIATION == 0.0:
        return np.zeros((len(moduli), n), dtype=np.uint64)
    # Marsaglia polar method, vectorized with exact draw-stream semantics:
    # every attempt consumes exactly 4 u32 draws (two canonicals); accepted
    # attempts yield two variates (y*mult now, x*mult saved as the spare).
    # The scalar state machine (StdNormalDistribution) is replayed by
    # walking the attempt stream in order.
    sigma = NOISE_STANDARD_DEVIATION
    spare = None  # scalar-state parity: spare from the last accepted attempt
    noise = np.zeros(n, dtype=np.int64)
    filled = 0
    while filled < n:
        need_attempts = max(16, int((n - filled) * 0.7) + 8)
        raw = prng.generate(16 * need_attempts)
        d = np.frombuffer(raw, dtype="<u4").astype(np.float64)
        c0 = (d[0::4] + d[1::4] * 4294967296.0) / 18446744073709551616.0
        c1 = (d[2::4] + d[3::4] * 4294967296.0) / 18446744073709551616.0
        np.minimum(c0, np.nextafter(1.0, 0.0), out=c0)
        np.minimum(c1, np.nextafter(1.0, 0.0), out=c1)
        x = 2.0 * c0 - 1.0
        y = 2.0 * c1 - 1.0
        r2 = x * x + y * y
        ok = (r2 <= 1.0) & (r2 != 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            mult = np.sqrt(-2.0 * np.log(r2) / r2)
        consumed = need_attempts
        for k in range(need_attempts):
            # walk attempts in order to preserve the saved-spare protocol
            if spare is not None:
                v = spare * sigma
                spare = None
                if abs(v) <= NOISE_MAX_DEVIATION:
                    noise[filled] = int(v)
                    filled += 1
            if filled >= n:
                consumed = k  # attempt k was pre-drawn but never consumed
                break
            if ok[k]:
                v = (y[k] * mult[k]) * sigma
                spare = x[k] * mult[k]
                if abs(v) <= NOISE_MAX_DEVIATION:
                    noise[filled] = int(v)
                    filled += 1
                if filled >= n:
                    consumed = k + 1
                    break
        if filled >= n and consumed < need_attempts:
            prng.pushback(raw[16 * consumed :])
    out = np.zeros((len(moduli), n), dtype=np.uint64)
    for j, q in enumerate(moduli):
        row = out[j]
        pos = noise > 0
        neg = noise < 0
        row[pos] = noise[pos].astype(np.uint64)
        row[neg] = (np.uint64(q) - (-noise[neg]).astype(np.uint64))
    return out


def sample_poly_uniform(prng: Blake2xbPRNG, moduli_with_ratio, n: int) -> np.ndarray:
    """Uniform poly mod each q_j as [L, N] (rlwe.cpp:101-129).

    Per limb: draw 63-bit candidates as (u32 << 31) | (u32 >> 1), reject at
    max_multiple = 2^63-1 - ((2^63-1) mod q) - 1, reduce.  Draw order is the
    reference's exactly (limb-major, per-coefficient rejection loops).

    moduli_with_ratio: iterable of Modulus (value + const_ratio for the
    Barrett reduce).
    """
    max_random = 0x7FFFFFFFFFFFFFFF
    L = len(moduli_with_ratio)
    out = np.zeros((L, n), dtype=np.uint64)
    # Each attempt consumes exactly one aligned (hi, lo) pair from the
    # stream, whether accepted or rejected, so the scalar do/while is
    # equivalent to: walk the pair stream in order, keep accepted values,
    # assign them to coefficients in order.  That form vectorizes.
    leftover = np.zeros(0, dtype=np.uint64)
    for j, m in enumerate(moduli_with_ratio):
        q = np.uint64(int(m.value) if hasattr(m, "value") else int(m))
        max_multiple = np.uint64(max_random - (max_random % int(q)) - 1)
        accepted = leftover[leftover < max_multiple] if leftover.size else leftover
        # Note: leftover pairs from the previous limb were drawn but not yet
        # consumed; they are re-screened against this limb's bound exactly
        # as the scalar loop would consume them next.
        pool = [accepted % q] if accepted.size else []
        got = sum(a.size for a in pool)
        while got < n:
            need = n - got
            draw = prng.draw_u32_array(2 * (need + need // 8 + 8)).astype(np.uint64)
            r = (draw[0::2] << np.uint64(31)) | (draw[1::2] >> np.uint64(1))
            take = r[r < max_multiple]
            # Track where coefficient n lands so extra pairs carry over.
            if got + take.size >= n:
                # find the cut in the raw pair stream
                ok = (r < max_multiple).cumsum()
                cut = int(np.searchsorted(ok, need))  # index of the pair
                take = r[: cut + 1]
                take = take[take < max_multiple]
                leftover = r[cut + 1 :]
            pool.append((take % q).astype(np.uint64))
            got += take.size
        out[j] = np.concatenate(pool)[:n]
    return out
