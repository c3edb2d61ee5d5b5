"""The design of K10 ``infty_norm`` (csrc/infty_norm.cu) modelled on the CPU,
against the JAX package.

The launch geometry that the host picks (``infty_norm_geometry``: a row
over a cluster of 2^log_tiles CTAs, each thread reading two coefficients
a step for ``iters`` steps) and the kernel's index mapping (the rows and
a row's tiles on the grid's x axis split by a shift and a mask, the limb
on y), emulated in Python over every CTA and thread (numpy over a CTA's
threads): every coefficient is read exactly once, each warp's maximum goes
to its own slot of rank 0's shared memory by one store (at most 64 words,
read by rank 0's first warp as lane and lane + 32), and the row's word equals the JAX
``poly_infty_norm`` run on numpy; at N from 2 to 65536, 1 to 64 limbs and
up to 320 rows (where the rows alone fill the card: no cluster),
with the centred lift's edges 0, p >> 1, (p >> 1) + 1 and p - 1 planted
at every tile's first and last coefficient.  The geometry fits what the
kernel's host code accepts (threads a multiple of 32 up to 256, clusters
of at most 8 CTAs, the row covered).  No jit: everything runs on numpy.
"""

import numpy as np
import pytest

from gemini_seal_tpu.ops import dyadic as jd
from gemini_seal_tpu_torch.ops import dyadic as td
from gemini_seal_tpu_torch.utils.numth import get_primes
from torch_helpers import one_torch_thread  # noqa: F401


def _emulate(a, p, geo):
    """infty_norm_kernel over the grid: (row max [R, L], reads [R, L, N])."""
    R, L, N = a.shape
    T, C, iters = geo["threads"], 1 << geo["log_tiles"], geo["iters"]
    warps = T // 32
    half = p >> np.uint64(1)
    reads = np.zeros(a.shape, dtype=np.int64)
    slots = np.zeros((R, L, C * warps), dtype=np.uint64)   # rank 0's shared words
    stores = np.zeros(C * warps, dtype=np.int64)           # stores into each slot
    t = np.arange(T)
    for tile in range(C):
        m = np.zeros((R, L, T), dtype=np.uint64)
        for it in range(iters):
            j = (it * T * C + tile * T + t) * 2
            ok = j < N
            for jj in (j[ok], j[ok] + 1):
                np.add.at(reads, (slice(None), slice(None), jj), 1)
                v = a[:, :, jj]
                mag = np.where(v > half[None, :, None], p[None, :, None] - v, v)
                m[:, :, ok] = np.maximum(m[:, :, ok], mag)
        # the warps' shuffle reduction, lane 0 storing into slot tile * warps + warp
        slots[:, :, tile * warps:(tile + 1) * warps] = m.reshape(R, L, warps, 32).max(axis=-1)
        stores[tile * warps:(tile + 1) * warps] += 1
    words = warps * C
    assert words <= 64
    assert (stores == 1).all()   # every slot stored once, by one warp
    lanes = np.arange(32)
    first = np.where(lanes[None, None, :] < words, slots[:, :, np.minimum(lanes, words - 1)], 0)
    second = np.where(lanes[None, None, :] + 32 < words,
                      slots[:, :, np.minimum(lanes + 32, words - 1)], 0)
    return np.maximum(first, second).max(axis=-1), reads


@pytest.mark.parametrize("N", [2, 32, 64, 128, 1024, 4096, 8192, 65536])
@pytest.mark.parametrize("L,R", [(1, None), (3, None), (64, None), (2, 160)])
def test_geometry_reads_each_coefficient_once(N, L, R):
    if R is None:
        R = 1 if L == 64 and N == 65536 else 3 if N <= 8192 else 2
    elif N > 8192:
        R = 16
    geo = td.infty_norm_geometry(N, R * L)
    T, C = geo["threads"], 1 << geo["log_tiles"]
    assert 32 <= T <= 256 and T % 32 == 0 and C <= td.INFTY_NORM_MAX_CLUSTER
    assert T * C * geo["iters"] * 2 >= N
    mods = get_primes(max(N, 1024), 50, 1) + get_primes(max(N, 1024), 40, 1) + \
        get_primes(max(N, 1024), 60, 1)
    p = np.array([mods[li % 3] for li in range(L)], dtype=np.uint64)
    rng = np.random.default_rng(N + L)
    a = (rng.integers(0, 1 << 62, size=(R, L, N), dtype=np.uint64) % p[None, :, None])
    # the lift's edges at each tile's first and last coefficient
    span = 2 * T
    edges = np.array([0, 0, 0, 0], dtype=np.uint64)
    for li in range(L):
        edges = np.array([0, p[li] >> 1, (p[li] >> 1) + 1, p[li] - 1], dtype=np.uint64)
        for s, start in enumerate(range(0, N, span)):
            a[s % R, li, start] = edges[s % 4]
            a[(s + 1) % R, li, min(start + span, N) - 1] = edges[(s + 2) % 4]
    got, reads = _emulate(a, p, geo)
    assert (reads == 1).all()
    want = jd.poly_infty_norm(a, jd.LimbConstants.from_moduli([int(v) for v in p]))
    np.testing.assert_array_equal(got, want)


def test_geometry_clusters_few_rows_only():
    """ex1's four rows (N = 4096) take clusters of eight CTAs of 256
    threads, one 16-byte load a thread; bench.py's 1,024 rows of 8192 take
    one CTA a row (the rows alone fill the card); in between the cluster
    brings the call to about two CTAs an SM."""
    assert td.infty_norm_geometry(4096, 4) == {"threads": 256, "log_tiles": 3, "iters": 1}
    assert td.infty_norm_geometry(8192, 1024) == {"threads": 256, "log_tiles": 0, "iters": 16}
    assert td.infty_norm_geometry(8192, 64) == {"threads": 256, "log_tiles": 2, "iters": 4}
    assert td.infty_norm_geometry(65536, 2)["iters"] == 16
    assert td.infty_norm_geometry(1024, 4) == {"threads": 64, "log_tiles": 3, "iters": 1}
    assert td.infty_norm_geometry(32, 4) == {"threads": 32, "log_tiles": 0, "iters": 1}
