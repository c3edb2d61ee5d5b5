"""The port's encrypted matrix product and encrypted attention against the
JAX package on the CPU, exact equality: build_ckks_matmul_square at d=4
(N=32, one head; N=128, four heads), attention_plan on a grid of inputs,
build_ckks_attention at d=4 (N=32, 18 levels) with the Chebyshev and the
Taylor exp and with two heads (N=64), and the plaintexts these steps
encode at a prime (or a ratio of primes) as the scale: the phi masks at
q_1, the sigma, tau and row-sum diagonals at q_0 and q_e, the exp
realignment at Dl q / sc.  Every output also decrypts within the JAX
test's tolerance (tests/test_pipelines.py, tests/test_attention.py).

The JAX steps run eagerly on numpy inputs (test_torch_zoo.py's
``eager_jax``), so nothing is compiled; every kernel call of the port is
held to the contiguity the card demands (torch_helpers.py).

test_attention_d16_n512_digests (marked slow) recomputes from the JAX
package the sha256 digests that chip_smoke.py holds the card's attention
at bench_all.py's d=16 cell to.
"""

import math
import os
import sys

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.ciphertext import Ciphertext as JCiphertext
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from test_torch_zoo import (SCALE, Ring, _context, _digest, _key_array, _run_both,  # noqa: F401
                            eager_jax)
from torch_helpers import one_torch_thread  # noqa: F401

MATMUL_BITS = [50, 40, 40, 40, 40, 50]
ATTN_BITS = [50] + [40] * 18 + [50]        # attention_plan(4, iters=4): 18 levels


@pytest.fixture(scope="module")
def rings():
    cache = {}

    def get(n, bits):
        key = (n, tuple(bits))
        if key not in cache:
            cache[key] = Ring("CKKS", n, bits)
        return cache[key]

    return get


def _pack(ring, mats, batch=2):
    return ring.encrypt(np.asarray(mats).reshape(-1), batch=batch)


@pytest.mark.parametrize("heads", [1, 4])
def test_matmul_square(rings, heads):
    d = 4
    ring = rings(2 * heads * d * d, MATMUL_BITS)
    jfn, jpid, jscale = jp.build_ckks_matmul_square(ring.jc, d, SCALE, ring.jcod, heads=heads)
    tfn, pid, scale = T.build_ckks_matmul_square(ring.tc, d, SCALE, ring.tcod, heads=heads,
                                                 device="cpu")
    assert (pid, scale, tfn.rot_steps) == (jpid, jscale, jfn.rot_steps)
    if heads == 1:
        assert len(tfn.rot_steps) == 3 * (d - 1)
    jk, tk = ring.keys(tfn.rot_steps)
    rng = np.random.default_rng(11 if heads == 1 else 29)
    A = rng.uniform(-1, 1, size=(heads, d, d))
    B = rng.uniform(-1, 1, size=(heads, d, d))
    a, b = _pack(ring, A), _pack(ring, B)
    got = _run_both(jfn, tfn, (a, b, jk, ring.rk),
                    (to_tensor(a, "cpu"), to_tensor(b, "cpu"), tk, to_tensor(ring.rk, "cpu")))
    dec = ring.decode(got[1], pid, scale)[:heads * d * d].reshape(heads, d, d)
    assert np.abs(dec - A @ B).max() < 1e-2
    L = [len(ring.tc.get_context_data(p).parms.coeff_modulus) for p in (ring.tc.first_parms_id,
                                                                        pid)]
    assert L[0] - L[1] == 3
    # one ciphertext without a batch axis: the same rows
    got1 = tfn(to_tensor(a[0], "cpu"), to_tensor(b[0], "cpu"), tk, to_tensor(ring.rk, "cpu"))
    np.testing.assert_array_equal(to_numpy(got1), to_numpy(got[0]))
    with pytest.raises(ValueError, match="heads\\*d\\*d"):
        T.build_ckks_matmul_square(ring.tc, d + 1, SCALE, ring.tcod, heads=heads, device="cpu")


def test_attention_plan():
    for d in (2, 4, 8, 16, 32, 64):
        for mb in (0.25, 0.5, 0.7, 1.0):
            for deg in (3, 4, 6):
                for iters in (None, 2, 4):
                    for target in (1e-3, 1e-5):
                        assert T.attention_plan(d, mb, deg, iters, target) == \
                            jp.attention_plan(d, mb, deg, iters, target)
    assert T.attention_plan(32) == jp.attention_plan(32) and T.attention_plan(32)[0] == 20
    assert T.attention_plan(16)[0] == 19 and T.attention_plan(8)[0] == 18


def _attention_want(Q, K, V, d):
    S = Q @ np.swapaxes(K, -1, -2) / np.sqrt(d)
    P = np.exp(S) / np.exp(S).sum(axis=-1, keepdims=True)
    return P @ V


@pytest.mark.parametrize("exp_mode,heads,tol", [("cheby", 1, 5e-4), ("taylor", 1, 5e-3),
                                                ("cheby", 2, 5e-4)])
def test_attention(rings, exp_mode, heads, tol):
    d = 4
    ring = rings(2 * heads * d * d, ATTN_BITS)
    jrun, jpid, jscale, jsteps = jp.build_ckks_attention(ring.jc, d, SCALE, ring.jcod, iters=4,
                                                         exp_mode=exp_mode, heads=heads)
    trun, pid, scale, steps = T.build_ckks_attention(ring.tc, d, SCALE, ring.tcod, iters=4,
                                                     exp_mode=exp_mode, heads=heads,
                                                     device="cpu")
    assert (pid, scale, steps) == (jpid, jscale, jsteps)
    assert min(steps) < 0                       # the row-sum map's negative steps
    jk, tk = ring.keys(steps)
    rng = np.random.default_rng(23 if heads == 1 else 31)
    Q, K, V = (rng.uniform(-0.5, 0.5, (heads, d, d)) for _ in range(3))
    KT = np.swapaxes(K, -1, -2)
    q, kt, v = _pack(ring, Q), _pack(ring, KT), _pack(ring, V)
    got = _run_both(jrun, trun, (q, kt, v, jk, ring.rk),
                    (to_tensor(q, "cpu"), to_tensor(kt, "cpu"), to_tensor(v, "cpu"), tk,
                     to_tensor(ring.rk, "cpu")))
    dec = ring.decode(got[1], pid, scale)[:heads * d * d].reshape(heads, d, d)
    assert np.abs(dec - _attention_want(Q, K, V, d)).max() < tol
    L = [len(ring.tc.get_context_data(p).parms.coeff_modulus) for p in (ring.tc.first_parms_id,
                                                                        pid)]
    assert L[0] - L[1] == 18
    if heads == 1:
        with pytest.raises(ValueError, match="exp_mode"):
            T.build_ckks_attention(ring.tc, d, SCALE, ring.tcod, exp_mode="pade", device="cpu")


def test_prime_scale_encodes(rings):
    """The plaintexts the matmul and attention encode at a prime (or a
    ratio of primes) as the scale, equal bit for bit: the phi masks at q_1
    (one encode_stack call, as the matmul makes them), the sigma and tau
    diagonals at q_0, the row-sum diagonals at q_e and the realignments of
    E at Dl q_e70 / sc_e70 and of P at Dl q_p / sc_p."""
    d = 4
    ring = rings(2 * d * d, ATTN_BITS)
    s = d * d
    cds = [ring.jc.first_context_data()]
    while cds[-1].next_context_data is not None:
        cds.append(cds[-1].next_context_data)
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    pids = [c.parms_id for c in cds]
    j_idx, i_idx = np.arange(s) % d, np.arange(s) // d
    masks = [(j_idx < d - k).astype(float).tolist() for k in range(d)]
    masks += [((j_idx >= d - k) & (i_idx < d - k)).astype(float).tolist() for k in range(1, d)]
    masks.append([0.0] * s)
    diags = [((i_idx == k) & (j_idx < d - k)).astype(float).tolist() for k in range(d)]
    diags += [(j_idx == j).astype(float).tolist() for j in range(d)]
    R = 0.5 * (d * math.exp(-0.5) + d * math.exp(0.5))
    rs = [(((j_idx + o) < d).astype(float) / R).tolist() for o in range(d)]
    for vecs, scale, lvl in ((masks, q[1], 1), (diags, q[0], 0), (rs, q[7], 7)):
        got = ring.tcod.encode_stack(vecs, scale, pids[lvl])
        for v, g in zip(vecs, got):
            want = np.asarray(ring.jcod.encode(v, scale, pids[lvl]).data)
            np.testing.assert_array_equal(want, to_numpy(g))
    # the exp realignment at level 6 (S at level 3 at the matmul's output
    # scale, poly_eval's at sc_s 2^30) and P's at level 15
    sc_s = (SCALE * SCALE * q[1]) / (q[1] * q[2])
    for scale, lvl in ((SCALE * q[6] / (sc_s * 2.0 ** 30), 6), (SCALE * q[15] / 1.3e12, 15)):
        want = np.asarray(ring.jcod.encode(1.0, scale, pids[lvl]).data)
        np.testing.assert_array_equal(want, to_numpy(ring.tcod.encode(1.0, scale,
                                                                      pids[lvl]).data))


def attention_d16_n512_cell():
    """bench_all.py's d=16 attention cell (bench_all.py:549-613) in the JAX
    package, keygen in its order: the context, the encoder, the key
    generator, the run, its output level and scale, the rotation steps, the
    three input ciphertexts' data (Q, K^T, V), the relin key, the rotation
    stack and the numpy attention."""
    d = 16
    n = 2 * d * d
    n_levels, _, _ = jp.attention_plan(d)
    ctx = _context(J, J.SchemeType.CKKS, n, [50] + [40] * n_levels + [50])
    kg = J.KeyGenerator(ctx)
    enc = J.Encryptor(ctx, public_key=kg.public_key())
    encoder = J.CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    run, pid, out_scale, rsteps = jp.build_ckks_attention(ctx, d, 2.0 ** 40, encoder)
    elts = [tool.get_elt_from_step(s) for s in rsteps]
    gk = kg.galois_keys(elts)
    rot = np.stack([_key_array(gk, e) for e in elts])
    rk = _key_array(kg.relin_keys(), 2)
    rng = np.random.default_rng(23)
    Q, K, V = (rng.uniform(-0.5, 0.5, (d, d)) for _ in range(3))
    cts = np.stack([np.asarray(enc.encrypt(encoder.encode(M.reshape(-1).tolist(),
                                                          2.0 ** 40)).data)
                    for M in (Q, K.T, V)])
    return ctx, encoder, kg, run, pid, out_scale, rsteps, cts, rk, rot, _attention_want(Q, K, V,
                                                                                       d)


@pytest.mark.slow
def test_attention_d16_n512_digests():
    """bench_all.py's d=16 attention cell run by the JAX package eagerly on
    the CPU: the digests of the three inputs' residues (stacked Q, K^T, V)
    and of the output's, the decode's max error against the numpy attention
    and the count of rotation steps, that chip_smoke.py expects of the
    port's batch row 0 on the card."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    ctx, encoder, kg, run, pid, out_scale, rsteps, cts, rk, rot, want = attention_d16_n512_cell()
    out = np.asarray(run(cts[0], cts[1], cts[2], rot, rk))
    got = np.asarray(encoder.decode(J.Decryptor(ctx, kg.secret_key).decrypt(
        JCiphertext(out, pid, True, out_scale))))[:256].reshape(16, 16)
    expect = chip_smoke.ATTENTION_D16_N512
    assert _digest(cts) == expect["input_sha256"]
    assert _digest(out) == expect["output_sha256"]
    assert float(np.abs(got - want).max()) == expect["max_err"]
    assert len(rsteps) == expect["rot_steps"]
