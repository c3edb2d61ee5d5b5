"""The port's comparison builders against the JAX package on the CPU, exact
equality: build_ckks_sign, build_ckks_relu and build_ckks_max (N=256 on
[50, 40 x 13, 50], as tests/test_pipelines.py's sign, ReLU and max tests),
build_ckks_rsqrt and build_ckks_sqrt (N=256 on [50, 40 x 14, 50]), the
host functions SIGN_F3, SIGN_G3 and sign_composite_reference on a grid of
inputs, and the scalar plaintexts the sign stages and the Newton stages
encode at a ratio of primes as the scale.  Every output also decrypts
within the JAX test's tolerance.

The JAX steps run eagerly on numpy inputs (test_torch_zoo.py's
``eager_jax``), so nothing is compiled; every kernel call of the port is
held to the contiguity the card demands (torch_helpers.py).

test_relu_n8192_digests (marked slow) recomputes from the JAX package the
sha256 digests that chip_smoke.py holds the card's ReLU at bench_all.py's
N=8192 cell to.
"""

import os
import sys

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.ciphertext import Ciphertext as JCiphertext
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.models import pipelines as tp
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from test_torch_zoo import (SCALE, Ring, _context, _digest, _key_array, _run_both,  # noqa: F401
                            eager_jax)
from torch_helpers import one_torch_thread  # noqa: F401

N = 256
SIGN_BITS = [50] + [40] * 13 + [50]
SQRT_BITS = [50] + [40] * 14 + [50]


@pytest.fixture(scope="module")
def ring13():
    return Ring("CKKS", N, SIGN_BITS)


@pytest.fixture(scope="module")
def ring14():
    return Ring("CKKS", N, SQRT_BITS)


def _sign_inputs(ring, batch=2):
    rng = np.random.default_rng(19)
    vals = rng.uniform(-1, 1, N // 2)
    vals[0], vals[1] = 0.15, -0.15          # the gap-edge probes of the JAX test
    return vals, ring.encrypt(vals, batch=batch)


def test_sign_constants_and_reference():
    assert tp.SIGN_F3 == jp.SIGN_F3 and tp.SIGN_G3 == jp.SIGN_G3
    x = np.linspace(-1.0, 1.0, 1001)
    for n_g, n_f in ((1, 2), (0, 1), (2, 2), (2, 3), (3, 0)):
        want = jp.sign_composite_reference(x, n_g=n_g, n_f=n_f)
        got = T.sign_composite_reference(x, n_g=n_g, n_f=n_f)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert T.sign_composite_reference(0.3) == jp.sign_composite_reference(0.3)


@pytest.mark.parametrize("n_g,n_f", [(1, 2), (0, 1)], ids=["default", "f3_only"])
def test_sign(ring13, n_g, n_f):
    jfn, jpid, jscale = jp.build_ckks_sign(ring13.jc, SCALE, ring13.jcod, n_g=n_g, n_f=n_f)
    tfn, pid, scale = T.build_ckks_sign(ring13.tc, SCALE, ring13.tcod, n_g=n_g, n_f=n_f,
                                        device="cpu")
    assert (pid, scale) == (jpid, jscale)
    vals, a = _sign_inputs(ring13)
    rk = to_tensor(ring13.rk, "cpu")
    got = _run_both(jfn, tfn, (a, ring13.rk), (to_tensor(a, "cpu"), rk))
    dec = ring13.decode(got[1], pid, scale)
    curve = T.sign_composite_reference(vals, n_g=n_g, n_f=n_f)
    assert np.abs(dec - curve).max() < 1e-2
    if (n_g, n_f) == (1, 2):
        m = np.abs(vals) >= 0.1
        assert np.abs(dec[m] - np.sign(vals[m])).max() < 2e-2
    L = [len(ring13.tc.get_context_data(p).parms.coeff_modulus)
         for p in (ring13.tc.first_parms_id, pid)]
    assert L[0] - L[1] == 4 * (n_g + n_f)


def test_relu(ring13):
    jfn, jpid, jscale = jp.build_ckks_relu(ring13.jc, SCALE, ring13.jcod)
    tfn, pid, scale = T.build_ckks_relu(ring13.tc, SCALE, ring13.tcod, device="cpu")
    assert (pid, scale) == (jpid, jscale)
    vals, a = _sign_inputs(ring13)
    got = _run_both(jfn, tfn, (a, ring13.rk), (to_tensor(a, "cpu"), to_tensor(ring13.rk, "cpu")))
    dec = ring13.decode(got[0], pid, scale)
    curve = T.sign_composite_reference(vals)
    assert np.abs(dec - vals * (1 + curve) / 2).max() < 1e-2
    m = np.abs(vals) >= 0.1
    assert np.abs(dec[m] - np.maximum(vals[m], 0)).max() < 2e-2
    with pytest.raises(ValueError, match="chain too short"):
        T.build_ckks_relu(ring13.tc, SCALE, ring13.tcod, n_g=2, device="cpu")


def test_max(ring13):
    jfn, jpid, jscale = jp.build_ckks_max(ring13.jc, SCALE, ring13.jcod)
    tfn, pid, scale = T.build_ckks_max(ring13.tc, SCALE, ring13.tcod, device="cpu")
    assert (pid, scale) == (jpid, jscale)
    rng = np.random.default_rng(23)
    a_v = rng.uniform(-0.5, 0.5, N // 2)
    b_v = rng.uniform(-0.5, 0.5, N // 2)
    a, b = ring13.encrypt(a_v, batch=2), ring13.encrypt(b_v, batch=2)
    got = _run_both(jfn, tfn, (a, b, ring13.rk),
                    (to_tensor(a, "cpu"), to_tensor(b, "cpu"), to_tensor(ring13.rk, "cpu")))
    dec = ring13.decode(got[1], pid, scale)
    m = np.abs(a_v - b_v) >= 0.1
    assert np.abs(dec[m] - np.maximum(a_v, b_v)[m]).max() < 2e-2
    g = ~m
    assert (dec[g] >= np.minimum(a_v, b_v)[g] - 1e-2).all()
    assert (dec[g] <= np.maximum(a_v, b_v)[g] + 1e-2).all()


@pytest.mark.parametrize("which", ["rsqrt", "sqrt"])
def test_rsqrt_sqrt(ring14, which):
    jbuild, tbuild = ((jp.build_ckks_rsqrt, T.build_ckks_rsqrt) if which == "rsqrt"
                      else (jp.build_ckks_sqrt, T.build_ckks_sqrt))
    jfn, jpid, jscale = jbuild(ring14.jc, SCALE, ring14.jcod, iters=3)
    tfn, pid, scale = tbuild(ring14.tc, SCALE, ring14.tcod, iters=3, device="cpu")
    assert (pid, scale) == (jpid, jscale)
    vals = np.random.default_rng(29).uniform(0.5, 1.5, N // 2)
    a = ring14.encrypt(vals, batch=2)
    got = _run_both(jfn, tfn, (a, ring14.rk), (to_tensor(a, "cpu"), to_tensor(ring14.rk, "cpu")))
    dec = ring14.decode(got[1], pid, scale)
    rel = np.abs(dec * np.sqrt(vals) - 1.0) if which == "rsqrt" else np.abs(
        dec / np.sqrt(vals) - 1.0)
    assert rel.max() < 2e-3
    L = [len(ring14.tc.get_context_data(p).parms.coeff_modulus)
         for p in (ring14.tc.first_parms_id, pid)]
    assert L[0] - L[1] == (12 if which == "rsqrt" else 13)
    # one ciphertext without a batch axis: the same rows
    got1 = tfn(to_tensor(a[0], "cpu"), to_tensor(ring14.rk, "cpu"))
    np.testing.assert_array_equal(to_numpy(got1), to_numpy(got[0]))
    with pytest.raises(ValueError, match="at least one"):
        T.build_ckks_rsqrt(ring14.tc, SCALE, ring14.tcod, iters=0, device="cpu")


def test_prime_scale_encodes(ring14):
    """The scalar plaintexts that the sign stages (c0..c3 at sigma_hi /
    sigma_x and sigma_w / sigma_x3), the gate's ones-plaintext and the
    Newton stages (1/2 and 3/2 at Dl^2 / sigma_u and Dl^2) encode at ratios
    of primes as the scale, equal bit for bit."""
    cds = [ring14.jc.first_context_data()]
    while cds[-1].next_context_data is not None:
        cds.append(cds[-1].next_context_data)
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    pids = [c.parms_id for c in cds]
    Dl = SCALE
    cases = []
    sigma = Dl
    for i, coeffs in enumerate([jp.SIGN_G3] + [jp.SIGN_F3] * 2):
        b = 4 * i
        x2 = sigma * sigma / q[b]
        x3 = x2 * sigma / q[b + 1]
        x4 = x2 * x2 / q[b + 1]
        w = Dl * Dl * x4 / q[b + 2]
        cases += [(coeffs[2], Dl * Dl / sigma, b + 2), (coeffs[3], Dl * Dl / x3, b + 2),
                  (coeffs[0], w / sigma, b + 3), (coeffs[1], w / x3, b + 3)]
        sigma = w / q[b + 3]
    cases.append((1.0, sigma, 12))
    sig_y = Dl
    for k in range(3):
        b = 4 * k
        sig_u = Dl * (sig_y * sig_y / q[b]) / q[b + 1]
        cases += [(0.5, Dl * Dl / sig_u, b + 2), (1.5, Dl * Dl, b + 2)]
        sig_y = sig_y * Dl * Dl / q[b + 2] / q[b + 3]
    for value, scale, lvl in cases:
        want = np.asarray(ring14.jcod.encode(float(value), scale, pids[lvl]).data)
        got = ring14.tcod.encode(float(value), scale, pids[lvl]).data
        np.testing.assert_array_equal(want, to_numpy(got))


def relu_n8192_cell():
    """bench_all.py's relu cell (bench_all.py:659-687) in the JAX package,
    keygen in its order: the context, the encoder, the key generator, the
    step, its output level and scale, the input ciphertext's data, the relin
    key and the slot values."""
    n = 8192
    ctx = _context(J, J.SchemeType.CKKS, n, [50] + [40] * 13 + [50])
    kg = J.KeyGenerator(ctx)
    enc = J.Encryptor(ctx, public_key=kg.public_key())
    encoder = J.CKKSEncoder(ctx)
    fn, pid, out_scale = jp.build_ckks_relu(ctx, 2.0 ** 40, encoder)
    vals = np.random.default_rng(7).uniform(-1, 1, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(vals.tolist(), 2.0 ** 40))
    return ctx, encoder, kg, fn, pid, out_scale, np.asarray(ct.data), _key_array(
        kg.relin_keys(), 2), vals


@pytest.mark.slow
def test_relu_n8192_digests():
    """bench_all.py's relu cell run by the JAX package eagerly on the CPU:
    the digests of the input and output residues and the decode's max error
    against x (1 + sign_composite_reference(x)) / 2, that chip_smoke.py
    expects of the port's batch row 0 on the card."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    ctx, encoder, kg, fn, pid, out_scale, x, rk, vals = relu_n8192_cell()
    out = np.asarray(fn(x, rk))
    got = np.asarray(encoder.decode(J.Decryptor(ctx, kg.secret_key).decrypt(
        JCiphertext(out, pid, True, out_scale))))
    want = vals * (1 + jp.sign_composite_reference(vals)) / 2
    expect = chip_smoke.RELU_N8192
    assert _digest(x) == expect["input_sha256"]
    assert _digest(out) == expect["output_sha256"]
    assert float(np.abs(got - want).max()) == expect["max_err"]
    assert expect["rot_steps"] == 0
