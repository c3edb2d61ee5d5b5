"""The port's NTT (gemini_seal_tpu_torch.ops.ntt) against the JAX package.

Tables equal to build_ntt_tables; the four transforms (plain versions, the
CPU path of the ``ntt`` kernel) equal to the jitted JAX transforms at
N in {256, 1024}, lazy ranges included, with a 60-bit prime among the
moduli (the JAX package's overflow-free forward butterfly); and, on two
rows, to the JAX host-plane transforms at N in {32768, 65536}, the rings
of the kernel's large-ring mode.
"""

import dataclasses

import jax
import numpy as np
import pytest

from gemini_seal_tpu.ops import ntt as jn
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import ntt as tn
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor

BITS = [60, 50, 40]


def _moduli(n):
    return [get_primes(n, b, 1)[0] for b in BITS]


@pytest.mark.parametrize("log_n", [8, 10])
def test_tables_equal(log_n):
    mods = _moduli(1 << log_n)
    j = jn.build_ntt_tables(log_n, mods)
    t = tn.build_ntt_tables(log_n, mods)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    dev = t.to("cpu")
    np.testing.assert_array_equal(to_numpy(dev.root_powers), j.root_powers)


@pytest.mark.parametrize("log_n", [8, 10])
@pytest.mark.parametrize("name,lazy_in", [
    ("ntt_forward_lazy", 4), ("ntt_forward", 4),
    ("ntt_inverse_lazy", 2), ("ntt_inverse", 2),
])
def test_transforms_equal(log_n, name, lazy_in):
    """Inputs span the transform's admissible range ([0, 4p) forward,
    [0, 2p) inverse) with a batch axis in front of the limb axis."""
    n = 1 << log_n
    mods = _moduli(n)
    tables = jn.build_ntt_tables(log_n, mods)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, lazy_in * p, size=(3, n), dtype=np.uint64)
                  for p in mods], axis=1)
    x[0, :, 0] = [lazy_in * p - 1 for p in mods]
    want = np.asarray(jax.jit(lambda v: getattr(jn, name)(v, tables))(x))
    got = getattr(tn, name)(to_tensor(x, "cpu"), tn.build_ntt_tables(log_n, mods).to("cpu"))
    np.testing.assert_array_equal(want, to_numpy(got))


_LARGE = {}


def _large_tables(log_n):
    """JAX and port tables at a large ring, built once per ring: a 60-bit
    prime (the BEHZ conversion primes' width) and a 59-bit one (config 5's
    outer primes)."""
    if log_n not in _LARGE:
        n = 1 << log_n
        mods = [get_primes(n, 60, 1)[0], get_primes(n, 59, 1)[0]]
        _LARGE[log_n] = (mods, jn.build_ntt_tables(log_n, mods),
                         tn.build_ntt_tables(log_n, mods).to("cpu"))
    return _LARGE[log_n]


@pytest.mark.parametrize("log_n", [15, 16])
@pytest.mark.parametrize("name,lazy_in", [
    ("ntt_forward_lazy", 4), ("ntt_forward", 4),
    ("ntt_inverse_lazy", 2), ("ntt_inverse", 2),
])
def test_large_ring_transforms_equal(log_n, name, lazy_in):
    """The rings above one block's shared memory (N = 32768, 65536; the
    kernel's large-ring mode on the card): the plain version on two rows,
    inputs over the whole lazy range, against the JAX host-plane NTT."""
    n = 1 << log_n
    mods, jtables, ttables = _large_tables(log_n)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, lazy_in * p, size=(1, n), dtype=np.uint64)
                  for p in mods], axis=1)
    x[0, :, -1] = [lazy_in * p - 1 for p in mods]
    want = getattr(jn, name)(x, jtables)
    got = getattr(tn, name)(to_tensor(x, "cpu"), ttables)
    np.testing.assert_array_equal(np.asarray(want), to_numpy(got))
