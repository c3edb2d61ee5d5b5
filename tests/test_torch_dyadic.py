"""The rest of ops/dyadic.py (modulo_poly_coeffs, negacyclic_shift_poly,
negacyclic_mono_mul_poly, poly_infty_norm) against the JAX package, exact
equality, at N=64 and 256 with three primes (60, 50 and 40 bits).

The JAX functions run on numpy (the package's host-plane dispatch); the
port's run their plain versions on the CPU, under ``contiguous_calls`` (the
contiguity the card's kernels demand).  The shifts cover k in {0, 1, N-1,
N, N+1, 2N-1}, beyond 2N and negative; the monomial's coefficient is one
scalar or a per-limb column, both in [p, 2p) (the fast plain lift's q_i - t
+ c reaches that); the norm has coefficients planted at p>>1 and p>>1 + 1;
the Barrett-64 reduction takes inputs up to 2^63 - 1.
"""

import numpy as np
import pytest
import torch

from gemini_seal_tpu.ops import dyadic as jd
from gemini_seal_tpu_torch.ops import dyadic as td
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.utils.numth import get_primes
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

RINGS = (64, 256)


class Ring:
    def __init__(self, n):
        self.n = n
        self.mods = [get_primes(n, b, 1)[0] for b in (60, 50, 40)]
        self.jl = jd.LimbConstants.from_moduli(self.mods)
        self.tl = td.LimbConstants.from_moduli(self.mods, "cpu")
        rng = np.random.default_rng(n)
        # [2, L, N] residues below each prime, with zeros planted (neg_mod(0) = 0)
        self.a = np.stack([rng.integers(0, p, size=(2, n), dtype=np.uint64)
                           for p in self.mods], axis=1)
        self.a[:, :, ::7] = 0


@pytest.fixture(scope="module", params=RINGS)
def ring(request):
    return Ring(request.param)


def _equal(want, got):
    np.testing.assert_array_equal(np.asarray(want, dtype=np.uint64), to_numpy(got))


SHIFTS = ("0", "1", "N-1", "N", "N+1", "2N-1", "2N+3", "-1")


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("coeff", ["none", "scalar", "per_limb"])
def test_negacyclic(ring, shift, coeff):
    n = ring.n
    k = {"0": 0, "1": 1, "N-1": n - 1, "N": n, "N+1": n + 1, "2N-1": 2 * n - 1,
         "2N+3": 2 * n + 3, "-1": -1}[shift]
    ta = to_tensor(ring.a, "cpu")
    with contiguous_calls():
        if coeff == "none":
            want = jd.negacyclic_shift_poly(ring.a, k, ring.jl)
            got = td.negacyclic_shift_poly(ta, k, ring.tl)
        elif coeff == "scalar":
            c = max(ring.mods) + 12345          # in [p, 2p) for every limb
            want = jd.negacyclic_mono_mul_poly(ring.a, np.uint64(c), k, ring.jl)
            got = td.negacyclic_mono_mul_poly(ta, c, k, ring.tl)
        else:
            col = np.array([2 * p - 1 - i for i, p in enumerate(ring.mods)],
                           dtype=np.uint64).reshape(-1, 1)
            want = jd.negacyclic_mono_mul_poly(ring.a, col, k, ring.jl)
            got = td.negacyclic_mono_mul_poly(ta, to_tensor(col, "cpu"), k, ring.tl)
    _equal(want, got)
    if coeff == "none" and k % (2 * n) == 0:
        assert got is ta  # x^0 returns its input, as the JAX function does
    # x^k then x^(2N-k) is the identity
    if coeff == "none":
        back = td.negacyclic_shift_poly(got.contiguous(), (2 * n - k) % (2 * n), ring.tl)
        assert torch.equal(back, ta)


def test_negacyclic_matches_polynomial_product(ring):
    """x^k times a, from the definition: coefficient i moves to i + k, and
    past X^N it comes back negated."""
    n, k = ring.n, ring.n + 5
    got = to_numpy(td.negacyclic_shift_poly(to_tensor(ring.a, "cpu"), k, ring.tl))
    for l, p in enumerate(ring.mods):
        row = [int(v) for v in ring.a[0, l]]
        want = [0] * n
        for i, v in enumerate(row):
            e = i + k
            sign = -1 if (e // n) % 2 else 1
            want[e % n] = (sign * v) % p
        assert [int(v) for v in got[0, l]] == want


def test_poly_infty_norm(ring):
    a = ring.a.copy()
    halves = np.array([p >> 1 for p in ring.mods], dtype=np.uint64)
    a[0, :, 3] = halves                  # the largest magnitude that stays positive
    a[1, :, 5] = halves + np.uint64(1)   # the first negative: |.| = p - (p>>1) - 1
    a[1, :, 6] = 0
    with contiguous_calls():
        got = td.poly_infty_norm(to_tensor(a, "cpu"), ring.tl)
    want = jd.poly_infty_norm(a, ring.jl)
    assert got.shape == (2, 3)
    _equal(want, got)
    assert [int(v) for v in to_numpy(got)[0]] == [p >> 1 for p in ring.mods]
    zero = td.poly_infty_norm(torch.zeros(3, ring.n, dtype=torch.int64), ring.tl)
    assert to_numpy(zero).tolist() == [0, 0, 0]


def test_modulo_poly_coeffs(ring):
    rng = np.random.default_rng(ring.n + 1)
    a = rng.integers(0, 1 << 63, size=(2, 3, ring.n), dtype=np.uint64)
    a[0, :, 0] = (1 << 63) - 1
    a[0, :, 1] = 0
    a[1, :, 2] = np.array(ring.mods, dtype=np.uint64)        # p itself
    a[1, :, 3] = np.array(ring.mods, dtype=np.uint64) - np.uint64(1)
    with contiguous_calls():
        got = td.modulo_poly_coeffs(to_tensor(a, "cpu"), ring.tl)
    _equal(jd.modulo_poly_coeffs(a, ring.jl), got)
    want = np.stack([a[:, l] % np.uint64(p) for l, p in enumerate(ring.mods)], axis=1)
    _equal(want, got)
