"""The port's encrypted model zoo against the JAX package on the CPU, exact
equality: build_ckks_dense_layer (both matvec forms, with and without the
square), build_ckks_mlp, build_ckks_conv2d (periodic and not),
strided_dense_diagonals, build_ckks_conv2d_mc, build_ckks_cnn (the
single-channel, multi-channel and strided networks of
tests/test_pipelines.py), build_bfv_matvec (with and without step 0),
build_ckks_logreg, build_ckks_logreg_train_step and build_ckks_inverse,
and the scalar and mask plaintexts their steps encode at a prime as the
scale.  Every output also decrypts within the JAX test's tolerance.

The CKKS builders run at N=256 on [50, 40 x 7, 50] (one special prime,
scale 2^40), the BFV matvec at N=64 as in the JAX test.  The JAX steps run
eagerly on numpy inputs (``jax.jit`` the identity, ``jax.numpy`` and
models/pipelines.py's ``jnp`` numpy), so nothing is compiled.  Every kernel
call of the port is held to the contiguity the card demands
(torch_helpers.py).

test_cnn16x16_digests (marked slow) recomputes from the JAX package the
sha256 digests that chip_smoke.py holds the card's CNN at bench_all.py's
N=4096 cell to.
"""

import hashlib
import os
import sys

import jax
import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.ciphertext import Ciphertext as JCiphertext
from gemini_seal_tpu.models import pipelines as jp
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.convert import galois_stack_from_array, secret_key_from_array
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

N = 256
BITS = [50] + [40] * 7 + [50]
SCALE = 2.0 ** 40


@pytest.fixture(autouse=True)
def eager_jax(monkeypatch):
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax, "numpy", np)
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **k: x)
    monkeypatch.setattr(jp, "jnp", np)
    with contiguous_calls():
        yield


def _context(M, scheme, n, bits, t=None, **kw):
    parms = M.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
    if t is not None:
        parms.set_plain_modulus(t)
    parms.set_random_seed(tuple(range(8)))
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


def _key_array(keys, idx):
    return np.stack([np.asarray(pk.data.data) for pk in keys.key(idx)])


class Ring:
    """One ring in both packages: the JAX package's keys, carried into the
    port, and the port's decryptor."""

    def __init__(self, scheme, n, bits, t=None):
        self.scheme = scheme
        self.jc = _context(J, getattr(J.SchemeType, scheme), n, bits, t)
        self.tc = _context(T, getattr(T.SchemeType, scheme), n, bits, t, device="cpu")
        self.jkg = J.KeyGenerator(self.jc)
        self.jenc = J.Encryptor(self.jc, public_key=self.jkg.public_key())
        self.tool = self.jc.first_context_data().galois_tool
        sk = secret_key_from_array(self.tc, np.asarray(self.jkg.secret_key.data))
        self.dec = T.Decryptor(self.tc, sk, device="cpu")
        if scheme == "CKKS":
            self.jcod, self.tcod = J.CKKSEncoder(self.jc), T.CKKSEncoder(self.tc, device="cpu")
            self.rk = _key_array(self.jkg.relin_keys(), 2)
        else:
            self.jcod, self.tcod = J.BatchEncoder(self.jc), T.BatchEncoder(self.tc, device="cpu")
        self._keys = {}

    def keys(self, steps):
        """The JAX package's Galois keys for `steps`, as numpy and as the
        port's stacked tensor."""
        steps = tuple(steps)
        if steps not in self._keys:
            elts = [self.tool.get_elt_from_step(s) for s in steps]
            gk = self.jkg.galois_keys(elts)
            arr = np.stack([_key_array(gk, e) for e in elts])
            self._keys[steps] = (arr, galois_stack_from_array(self.tc, arr))
        return self._keys[steps]

    def encrypt(self, values, batch=None):
        values = list(values)
        pt = self.jcod.encode(values, SCALE) if self.scheme == "CKKS" else self.jcod.encode(values)
        data = np.asarray(self.jenc.encrypt(pt).data)
        return data if batch is None else np.stack([data] * batch)

    def decode(self, out, pid, scale):
        ct = T.Ciphertext(out.contiguous(), pid, True, scale)
        return np.asarray(self.tcod.decode(self.dec.decrypt(ct)))


@pytest.fixture(scope="module")
def ckks():
    return Ring("CKKS", N, BITS)


def _run_both(jfn, tfn, jargs, targs):
    want = np.asarray(jfn(*jargs))
    got = tfn(*targs)
    np.testing.assert_array_equal(want, to_numpy(got))
    return got


def _square_dense(dim, seed, slots):
    rng = np.random.default_rng(seed)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    x = rng.uniform(-1, 1, size=dim)
    diagonals = {d: [M[i % dim, (i + d) % dim] for i in range(slots)] for d in range(dim)}
    return M, b, x, diagonals, [b[i % dim] for i in range(slots)]


def _conv_same(img, k):
    """SAME zero-padded 2-D convolution (correlation) of img by k."""
    h, w = img.shape
    kh, kw = k.shape
    out = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            for dy in range(-(kh // 2), kh // 2 + 1):
                for dx in range(-(kw // 2), kw // 2 + 1):
                    if 0 <= r + dy < h and 0 <= c + dx < w:
                        out[r, c] += k[dy + kh // 2, dx + kw // 2] * img[r + dy, c + dx]
    return out


@pytest.mark.parametrize("bsgs", [False, True], ids=["hoisted", "bsgs"])
@pytest.mark.parametrize("activation", ["square", None], ids=["square", "linear"])
def test_dense_layer(ckks, bsgs, activation):
    slots = N // 2
    M, b, x, diagonals, bias = _square_dense(4, 7, slots)
    jfn, jpid, jscale = jp.build_ckks_dense_layer(ckks.jc, diagonals, bias, SCALE, ckks.jcod,
                                                  activation=activation, bsgs=bsgs)
    tfn, pid, scale = T.build_ckks_dense_layer(ckks.tc, diagonals, bias, SCALE, ckks.tcod,
                                               activation=activation, bsgs=bsgs, device="cpu")
    assert (pid, scale, tfn.rot_steps) == (jpid, jscale, jfn.rot_steps)
    jk, tk = ckks.keys(tfn.rot_steps)
    a = ckks.encrypt([x[i % 4] for i in range(slots)], batch=2)
    rk = to_tensor(ckks.rk, "cpu")
    got = _run_both(jfn, tfn, (a, jk, ckks.rk), (to_tensor(a, "cpu"), tk, rk))
    want = M @ x + b
    want = want ** 2 if activation == "square" else want
    assert np.abs(ckks.decode(got[1], pid, scale)[:4] - want).max() < 1e-3


def test_mlp(ckks):
    slots = N // 2
    M1, b1, x, d1, bias1 = _square_dense(4, 9, slots)
    M2, b2, _, d2, bias2 = _square_dense(4, 10, slots)
    layers = [(d1, bias1, "square"), (d2, bias2, None)]
    jfn, jpid, jscale = jp.build_ckks_mlp(ckks.jc, layers, SCALE, ckks.jcod)
    tfn, pid, scale = T.build_ckks_mlp(ckks.tc, layers, SCALE, ckks.tcod, device="cpu")
    assert (pid, scale, tfn.rot_steps) == (jpid, jscale, jfn.rot_steps)
    jk, tk = ckks.keys(tfn.rot_steps[0])
    a = ckks.encrypt([x[i % 4] for i in range(slots)], batch=2)
    got = _run_both(jfn, tfn, (a, [jk, jk], ckks.rk),
                    (to_tensor(a, "cpu"), [tk, tk], to_tensor(ckks.rk, "cpu")))
    want = M2 @ ((M1 @ x + b1) ** 2) + b2
    assert np.abs(ckks.decode(got[0], pid, scale)[:4] - want).max() < 1e-2


@pytest.mark.parametrize("h,w,periodic,activation", [(5, 6, False, None),
                                                     (5, 6, False, "square"),
                                                     (4, 8, True, "square")])
def test_conv2d(ckks, h, w, periodic, activation):
    slots = N // 2
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, size=(h, w))
    k = rng.uniform(-0.5, 0.5, size=(3, 3))
    b = rng.uniform(-0.2, 0.2, size=h * w)
    k[0, 2] = 0.0                               # a zero tap adds no diagonal
    hw = h * w
    x = np.zeros(slots)
    x[:hw] = img.reshape(-1)
    bias = b.tolist()
    if periodic:
        x = np.tile(img.reshape(-1), slots // hw)
        bias = np.tile(b, slots // hw).tolist()
    out = jp.build_ckks_conv2d(ckks.jc, k, h, w, SCALE, ckks.jcod, bias=bias,
                               activation=activation, periodic=periodic)
    jfn, jpid, jscale, jsteps = out
    tfn, pid, scale, steps = T.build_ckks_conv2d(ckks.tc, k, h, w, SCALE, ckks.tcod, bias=bias,
                                                 activation=activation, periodic=periodic,
                                                 device="cpu")
    assert (pid, scale, steps) == (jpid, jscale, jsteps) and min(steps) < 0
    jk, tk = ckks.keys(steps)
    a = ckks.encrypt(x, batch=2)
    got = _run_both(jfn, tfn, (a, jk, ckks.rk),
                    (to_tensor(a, "cpu"), tk, to_tensor(ckks.rk, "cpu")))
    want = _conv_same(img, k).reshape(-1) + b
    want = want ** 2 if activation == "square" else want
    assert np.abs(ckks.decode(got[1], pid, scale)[:hw] - want).max() < 1e-3


@pytest.mark.parametrize("h,w,stride,n_out,slots", [(8, 8, 2, 10, 512), (5, 7, 2, 4, 128),
                                                    (6, 6, 3, 3, 64), (4, 4, 1, 16, 32)])
def test_strided_dense_diagonals(h, w, stride, n_out, slots):
    ph, pw = -(-h // stride), -(-w // stride)
    D = np.random.default_rng(31).uniform(-0.3, 0.3, size=(n_out, ph * pw))
    D[0, 1] = 0.0
    want = jp.strided_dense_diagonals(D, h, w, stride, slots)
    got = T.strided_dense_diagonals(D, h, w, stride, slots)
    assert got == want and list(got) == list(want)
    with pytest.raises(ValueError, match="pooled pixel count"):
        T.strided_dense_diagonals(D[:, 1:], h, w, stride, slots)


def test_conv2d_mc(ckks):
    slots = N // 2
    h = w = 6
    IC = OC = 2
    hw = h * w
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, size=(IC, h, w))
    K = rng.uniform(-0.4, 0.4, size=(OC, IC, 3, 3))
    b = rng.uniform(-0.1, 0.1, size=OC * hw)
    x = np.zeros(slots)
    x[:IC * hw] = img.reshape(-1)
    jfn, jpid, jscale, jsteps = jp.build_ckks_conv2d_mc(ckks.jc, K, h, w, SCALE, ckks.jcod,
                                                        bias=b.tolist())
    tfn, pid, scale, steps = T.build_ckks_conv2d_mc(ckks.tc, K, h, w, SCALE, ckks.tcod,
                                                    bias=b.tolist(), device="cpu")
    assert (pid, scale, steps) == (jpid, jscale, jsteps)
    jk, tk = ckks.keys(steps)
    a = ckks.encrypt(x, batch=2)
    got = _run_both(jfn, tfn, (a, jk, ckks.rk),
                    (to_tensor(a, "cpu"), tk, to_tensor(ckks.rk, "cpu")))
    want = np.stack([sum(_conv_same(img[ic], K[oc, ic]) for ic in range(IC))
                     for oc in range(OC)]).reshape(-1) + b
    assert np.abs(ckks.decode(got[0], pid, scale)[:OC * hw] - want).max() < 1e-3


def _cnn_case(which, slots):
    """(convs, dense, h, w, image, the numpy forward pass, outputs checked,
    the JAX test's tolerance) of tests/test_pipelines.py's CNNs."""
    if which == "single":                       # test_ckks_cnn
        h = w = 8
        hw = h * w
        rng = np.random.default_rng(5)
        img = rng.uniform(-0.5, 0.5, size=(h, w))
        k1 = rng.uniform(-0.5, 0.5, size=(3, 3))
        cb = rng.uniform(-0.1, 0.1, size=hw)
        dense_steps = [0, 1, 2, 3, 5, 9, 17]
        M = np.zeros((hw, hw))
        for d in dense_steps:
            for i in range(hw):
                M[i, (i + d) % hw] = rng.uniform(-0.2, 0.2)
        db = rng.uniform(-0.1, 0.1, size=hw)
        R = np.zeros((hw, hw))
        for d in (0, 1, 2):
            for i in range(hw):
                R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)
        want = R @ ((M @ ((_conv_same(img, k1).reshape(-1) + cb) ** 2) + db) ** 2)
        convs = [(k1, [cb[i % hw] for i in range(slots)], "square")]
        dense = [({d: [M[i % hw, (i + d) % hw] for i in range(slots)] for d in dense_steps},
                  [db[i % hw] for i in range(slots)], "square"),
                 ({d: [R[i % hw, (i + d) % hw] for i in range(slots)] for d in (0, 1, 2)},
                  [0.0] * slots, None)]
        return convs, dense, h, w, img, want, hw, 2e-2
    if which == "multi":                        # test_ckks_cnn_multichannel
        h = w = 4
        hw, OC = h * w, 2
        blk = OC * hw
        rng = np.random.default_rng(13)
        img = rng.uniform(-0.5, 0.5, size=(h, w))
        K = rng.uniform(-0.4, 0.4, size=(OC, 1, 3, 3))
        R = np.zeros((blk, blk))
        for d in (0, 1, 5):
            for i in range(blk):
                R[i, (i + d) % blk] = rng.uniform(-0.3, 0.3)
        conv = np.stack([_conv_same(img, K[oc, 0]) for oc in range(OC)])
        want = R @ (conv.reshape(-1) ** 2)
        dense = [({d: [R[i % blk, (i + d) % blk] for i in range(slots)] for d in (0, 1, 5)},
                  [0.0] * slots, None)]
        return [(K, None, "square")], dense, h, w, img, want, blk, 2e-2
    # test_strided_dense_readout: the readout's steps lie near 0 and near slots
    h = w = 8
    stride, n_out = 2, 10
    rng = np.random.default_rng(31)
    img = rng.uniform(-0.5, 0.5, size=(h, w))
    kern = rng.uniform(-0.4, 0.4, size=(3, 3))
    D = rng.uniform(-0.3, 0.3, size=(n_out, (h // stride) * (w // stride)))
    want = D @ (_conv_same(img, kern) ** 2)[::stride, ::stride].reshape(-1)
    readout = T.strided_dense_diagonals(D, h, w, stride, slots)
    return ([(kern, None, "square")], [(readout, [0.0] * slots, None)], h, w, img, want,
            n_out, 1e-2)


@pytest.mark.parametrize("which", ["single", "multi", "strided"])
def test_cnn(ckks, which):
    slots = N // 2
    convs, dense, h, w, img, want, n_check, tol = _cnn_case(which, slots)
    jfn, jpid, jscale = jp.build_ckks_cnn(ckks.jc, convs, dense, h, w, SCALE, ckks.jcod)
    tfn, pid, scale = T.build_ckks_cnn(ckks.tc, convs, dense, h, w, SCALE, ckks.tcod,
                                       device="cpu")
    assert (pid, scale, tfn.rot_steps) == (jpid, jscale, jfn.rot_steps)
    if which == "single":
        assert tfn.rot_steps[1] == [1, 2, 3, 9, 15]
    if which == "strided":
        assert max(tfn.rot_steps[1]) > slots // 2      # steps near slots
    stacks = [ckks.keys(s) for s in tfn.rot_steps]
    hw = h * w
    a = ckks.encrypt([img.reshape(-1)[i % hw] for i in range(slots)])   # no batch axis
    got = _run_both(jfn, tfn, (a, [s[0] for s in stacks], ckks.rk),
                    (to_tensor(a, "cpu"), [s[1] for s in stacks], to_tensor(ckks.rk, "cpu")))
    assert np.abs(ckks.decode(got, pid, scale)[:n_check] - want).max() < tol


@pytest.fixture(scope="module")
def bfv():
    return Ring("BFV", 64, [40, 40, 40, 40], t=J.PlainModulus.batching(64, 17).value)


@pytest.mark.parametrize("steps", [(0, 1, 2, 3), (1, 3, 6)], ids=["step0", "no_step0"])
def test_bfv_matvec(bfv, steps):
    n, dim = 64, 4
    t = bfv.jc.first_context_data().parms.plain_modulus.value
    rng = np.random.default_rng(5)
    M = rng.integers(0, 7, size=(dim, dim))
    x = rng.integers(0, 7, size=dim)
    diagonals = {d: [int(M[i % dim, (i + d) % dim]) for i in range(n)] for d in steps}
    diagonals[steps[-1]][3] = t - 2            # centred lift of an upper-half value
    jfn = jp.build_bfv_matvec(bfv.jc, diagonals, bfv.jcod)
    tfn = T.build_bfv_matvec(bfv.tc, diagonals, bfv.tcod, device="cpu")
    rot = [s for s in steps if s]
    jk, tk = bfv.keys(rot)
    a = bfv.encrypt([int(x[i % dim]) for i in range(n)], batch=2)
    got = _run_both(jfn, tfn, (a, jk), (to_tensor(a, "cpu"), tk))
    pid = bfv.tc.first_parms_id
    dec = bfv.tcod.decode(bfv.dec.decrypt(T.Ciphertext(got[1].contiguous(), pid, False)))
    half = n // 2
    xs = np.array([int(x[i % dim]) for i in range(n)], dtype=object)
    want = [0] * n
    for s, vec in diagonals.items():            # rows of the 2 x n/2 slot matrix rotate
        rolled = np.concatenate([np.roll(xs[:half], -s), np.roll(xs[half:], -s)])
        want = [(wv + int(v) * int(r)) % t for wv, v, r in zip(want, vec, rolled)]
    assert dec == want


def test_logreg(ckks):
    rng = np.random.default_rng(11)
    F = 4
    wts = rng.uniform(-0.5, 0.5, size=F)
    x = rng.uniform(-1, 1, size=F)
    jfn, jpid, jscale, jsteps = jp.build_ckks_logreg(ckks.jc, wts.tolist(), 0.3, SCALE,
                                                     ckks.jcod)
    tfn, pid, scale, steps = T.build_ckks_logreg(ckks.tc, wts.tolist(), 0.3, SCALE, ckks.tcod,
                                                 device="cpu")
    assert (pid, scale, steps) == (jpid, jscale, jsteps)
    jk, tk = ckks.keys(steps)
    xs = np.zeros(N // 2)
    xs[:F] = x
    a = ckks.encrypt(xs, batch=2)
    got = _run_both(jfn, tfn, (a, jk, ckks.rk),
                    (to_tensor(a, "cpu"), tk, to_tensor(ckks.rk, "cpu")))
    z = float(wts @ x + 0.3)
    assert abs(ckks.decode(got[0], pid, scale)[0] - (0.5 + 0.197 * z - 0.004 * z ** 3)) < 1e-2


def test_logreg_train_step(ckks):
    m, F, Bf = 8, 4, 4
    slots = N // 2
    rng = np.random.default_rng(19)
    X = rng.uniform(-1, 1, size=(m, F))
    y = rng.integers(0, 2, size=m).astype(float)
    w = rng.uniform(-0.5, 0.5, size=F)
    z = X @ w
    want = w - 0.1 * (X.T @ (0.5 + 0.197 * z - 0.004 * z ** 3 - y))
    xs = np.zeros(slots)
    for i in range(m):
        xs[i * Bf:i * Bf + F] = X[i]
    ws = np.zeros(slots)
    for i in range(slots // Bf):
        ws[i * Bf:i * Bf + F] = w
    jfn, jpid, jscale, jsteps = jp.build_ckks_logreg_train_step(ckks.jc, m, F, y.tolist(), 0.1,
                                                                SCALE, ckks.jcod)
    tfn, pid, scale, steps = T.build_ckks_logreg_train_step(ckks.tc, m, F, y.tolist(), 0.1,
                                                            SCALE, ckks.tcod, device="cpu")
    assert (pid, scale, steps) == (jpid, jscale, jsteps) and scale == SCALE
    jk, tk = ckks.keys(steps)
    ax, aw = ckks.encrypt(xs), ckks.encrypt(ws)
    got = _run_both(jfn, tfn, (ax, aw, jk, ckks.rk),
                    (to_tensor(ax, "cpu"), to_tensor(aw, "cpu"), tk, to_tensor(ckks.rk, "cpu")))
    dec = ckks.decode(got, pid, scale)
    for blk in (0, 1, m - 1):                   # replicated across the blocks
        assert np.abs(dec[blk * Bf:blk * Bf + F] - want).max() < 1e-2


def test_inverse(ckks):
    iters = 3
    jfn, jpid, jscale = jp.build_ckks_inverse(ckks.jc, SCALE, ckks.jcod, iters=iters)
    tfn, pid, scale = T.build_ckks_inverse(ckks.tc, SCALE, ckks.tcod, iters=iters, device="cpu")
    assert (pid, scale) == (jpid, jscale)
    vals = np.random.default_rng(17).uniform(0.4, 1.6, N // 2)
    a = ckks.encrypt(vals, batch=2)
    got = _run_both(jfn, tfn, (a, ckks.rk), (to_tensor(a, "cpu"), to_tensor(ckks.rk, "cpu")))
    rel = np.abs(ckks.decode(got[1], pid, scale) - 1.0 / vals) * vals
    assert rel.max() < 2e-3
    L = [len(ckks.tc.get_context_data(p).parms.coeff_modulus) for p in (ckks.tc.first_parms_id,
                                                                        pid)]
    assert L[0] - L[1] == iters + 1
    with pytest.raises(ValueError, match="at least one"):
        T.build_ckks_inverse(ckks.tc, SCALE, ckks.tcod, iters=0, device="cpu")


def test_prime_scale_encodes(ckks):
    """The scalar and mask plaintexts that the logreg head, its training
    step and the reciprocal encode at a prime (or a ratio of primes) as the
    scale, equal bit for bit."""
    cds = [ckks.jc.first_context_data()]
    while cds[-1].next_context_data is not None:
        cds.append(cds[-1].next_context_data)
    q = [c.parms.coeff_modulus[-1].value for c in cds]
    pids = [c.parms_id for c in cds]
    sc = SCALE
    s1 = sc * sc / q[0]
    sz2 = s1 * s1 / q[2]
    sp = s1 * sz2 / q[4] * sc / q[5]
    mask1 = np.zeros(N // 2)
    mask1[::4] = 1.0
    mask2 = np.zeros(N // 2)
    mask2[:4] = 0.1
    cases = [(-0.004, float(q[2]), 2), (-0.004, float(q[3]), 3), (0.197, sz2, 4),
             (0.5, s1 * (s1 * s1 / q[1]) / q[3], 4), (mask1.tolist(), float(q[1]), 1),
             (mask2.tolist(), q[6] * sc / sp, 6), (2.0, sc, 0), (1.0, sc * sc / q[0], 1)]
    for value, scale, lvl in cases:
        want = np.asarray(ckks.jcod.encode(value, scale, pids[lvl]).data)
        got = ckks.tcod.encode(value, scale, pids[lvl]).data
        np.testing.assert_array_equal(want, to_numpy(got))


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.uint64).tobytes()).hexdigest()


def cnn16x16_cell():
    """bench_all.py's cnn cell (bench_all.py:341-398) in the JAX package,
    keygen in its order: the context, the encoder, the key generator, the
    network, its output level and scale, the input ciphertext's data, the
    relin key and the Galois stacks, and the numpy forward pass."""
    n, h = 4096, 16
    hw = h * h
    ctx = _context(J, J.SchemeType.CKKS, n, [50] + [40] * 6 + [50])
    kg = J.KeyGenerator(ctx)
    enc = J.Encryptor(ctx, public_key=kg.public_key())
    encoder = J.CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    rng = np.random.default_rng(2)
    slots = encoder.slot_count
    kern = rng.uniform(-0.4, 0.4, size=(3, 3))
    Md = np.zeros((hw, hw))
    for d in range(16):
        for i in range(hw):
            Md[i, (i + d) % hw] = rng.uniform(-0.15, 0.15)
    R = np.zeros((hw, hw))
    for d in range(10):
        for i in range(hw):
            R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)
    dense = [({d: [Md[i % hw, (i + d) % hw] for i in range(slots)] for d in range(16)},
              [0.0] * slots, "square"),
             ({d: [R[i % hw, (i + d) % hw] for i in range(slots)] for d in range(10)},
              [0.0] * slots, None)]
    fn, pid, out_scale = jp.build_ckks_cnn(ctx, [(kern, None, "square")], dense, h, h,
                                           2.0 ** 40, encoder, bsgs=True)
    stacks = []
    for steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in steps]
        gk = kg.galois_keys(elts)
        stacks.append(np.stack([_key_array(gk, e) for e in elts]))
    img = [rng.uniform(0, 1) for _ in range(hw)]
    x = enc.encrypt(encoder.encode([img[i % hw] for i in range(slots)], 2.0 ** 40))
    want = R @ ((Md @ (_conv_same(np.reshape(img, (h, h)), kern).reshape(-1) ** 2)) ** 2)
    return (ctx, encoder, kg, fn, pid, out_scale, np.asarray(x.data), _key_array(rk, 2),
            stacks, want)


@pytest.mark.slow
def test_cnn16x16_digests():
    """bench_all.py's CNN cell run by the JAX package eagerly on the CPU:
    the digests of the input and output residues, the decode's max error
    against the numpy forward pass and the rotation-step counts per layer,
    that chip_smoke.py expects of the port's batch row 0 on the card."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    ctx, encoder, kg, fn, pid, out_scale, x, rk, stacks, want = cnn16x16_cell()
    out = np.asarray(fn(x, stacks, rk))
    got = np.asarray(encoder.decode(J.Decryptor(ctx, kg.secret_key).decrypt(
        JCiphertext(out, pid, True, out_scale))))
    expect = chip_smoke.CNN16X16_N4096
    assert _digest(x) == expect["input_sha256"]
    assert _digest(out) == expect["output_sha256"]
    assert float(np.abs(got[:256] - want).max()) == expect["max_err"]
    assert [len(s) for s in fn.rot_steps] == expect["rot_steps_lengths"]
