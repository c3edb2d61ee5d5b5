"""The design of K8 ``mod_raise`` and K9 ``negacyclic`` (csrc/mod_raise.cu,
csrc/negacyclic.cu) modelled on the CPU, against the JAX package.

- The by-value constants that the host packs into each launch's parameter
  struct (``mod_raise_constants``, ``negacyclic_constants``) against the
  JAX package's own constants: the primes, their Barrett ratios, p - q0
  mod p from the JAX ModRaisePlan, and for K9's Shoup form the host-reduced
  coefficient c mod p and floor(w 2^64 / p) (the JAX NTT's ``_shoupify``)
  at c in {0, 1, p - 1, p, 2p - 1}, whose Shoup product equals the JAX
  Barrett ``mul_mod`` by c; both refuse more than the 64 primes a launch
  takes.
- The launch geometry that the host picks (``mod_raise_geometry``,
  ``negacyclic_geometry``) and each kernel's index mapping (the rows and a
  power of two of tiles on the grid's x axis, split by a shift and a mask),
  emulated in Python over every CTA and thread (numpy over a CTA's
  threads), write every output exactly once and equal the JAX functions run
  on numpy (the JAX mod_raise through its NTTs, negacyclic_shift_poly and
  negacyclic_mono_mul_poly): at the N=4096 refresh's and ex1's shapes, at
  N = 2, 64 and 1024, at rows that do not fill a CTA and 70,000 rows, at k
  in {0, 1, N - 1, N, N + 1, 2N - 1}, K9 in each form (the shift, the
  Barrett product by a per-limb coefficient up to 2p - 1, the Shoup
  product by a scalar).

The emulation's arithmetic is the JAX package's modops on numpy, fed the
packed constants, so what is tested is what the kernels add: the mapping
and the constants.  No jit: everything runs eagerly on numpy.
"""

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.models import bootstrap as jb
from gemini_seal_tpu.ops import dyadic as jd
from gemini_seal_tpu.ops import modops as jm
from gemini_seal_tpu.ops.ntt import _shoupify
from gemini_seal_tpu.ops.ntt import ntt_forward as jntt_forward
from gemini_seal_tpu.ops.ntt import ntt_inverse as jntt_inverse
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.models import bootstrap as tb
from gemini_seal_tpu_torch.ops import dyadic as td
from gemini_seal_tpu_torch.ops import modraise as tmr
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from gemini_seal_tpu_torch.utils.numth import get_primes
from torch_helpers import one_torch_thread  # noqa: F401

U = np.uint64


def _ckks(M, n, bits, **kw):
    parms = M.EncryptionParameters(M.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
    parms.set_n_special_primes(1)
    parms.set_random_seed(tuple(range(8)))
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


# --- K8: constants


def _plans(n, bits):
    jc, tc = _ckks(J, n, bits), _ckks(T, n, bits, device="cpu")
    plans = []
    for ctx, M in ((jc, jb), (tc, None)):
        top, last = ctx.first_context_data(), ctx.last_context_data()
        plan = (jb.ModRaisePlan(ctx, last.parms_id, top.parms_id) if M is not None else
                tb.ModRaisePlan(ctx, last.parms_id, top.parms_id))
        plans.append((ctx, top, last, plan))
    return plans


def test_mod_raise_constants_match_the_jax_plan():
    (jc, jtop, _, jplan), (_, ttop, _, tplan) = _plans(64, [59, 40, 40, 41, 45, 59])
    got = tmr.mod_raise_constants(to_numpy(tplan.p), to_numpy(tplan.ratio1),
                                  to_numpy(tplan.q0_mod_p))
    r1 = np.array([m.const_ratio[1] for m in jtop.parms.coeff_modulus], dtype=U)
    want = np.concatenate([jplan.p.reshape(-1), r1, (jplan.p - jplan.q0_mod_p).reshape(-1)])
    np.testing.assert_array_equal(got, want)
    assert got[2 * len(r1)] == jplan.p[0, 0]  # p_0 = q0: a negative c keeps its value


def test_mod_raise_constants_cap():
    ps = get_primes(1024, 50, 65)
    r1 = [T.Modulus(p).const_ratio[1] for p in ps]
    qm = [ps[0] % p for p in ps]
    assert tmr.mod_raise_constants(ps[:64], r1[:64], qm[:64]).size == 3 * 64
    with pytest.raises(ValueError, match="1 to 64 primes"):
        tmr.mod_raise_constants(ps, r1, qm)
    with pytest.raises(ValueError, match="one constant each"):
        tmr.mod_raise_constants(ps[:3], r1[:2], qm[:3])
    with pytest.raises(ValueError, match="below p"):
        tmr.mod_raise_constants(ps[:2], r1[:2], [0, ps[1]])


# --- K8: geometry and threads


def _k8_threads(geo, B, L, N, c, k, half):
    """csrc/mod_raise.cu's threads over the whole grid: (out, writes).  Grid
    x: B << log_tiles CTAs (the row and the tile by a shift and a mask),
    y: the limb groups; one thread a coefficient."""
    threads, lpt, lt = geo["threads"], geo["lpt"], geo["log_tiles"]
    assert geo["groups"] == -(-L // lpt)
    out = np.zeros((B, L, N), dtype=U)
    writes = np.zeros((B, L, N), dtype=np.int64)
    p, r1, pq = k[:L], k[L:2 * L], k[2 * L:]
    for bx in range(B << lt):
        tile, b = bx & ((1 << lt) - 1), bx >> lt
        col = tile * threads + np.arange(threads)
        col = col[col < N]                                 # the live threads
        cv = c[b, col]
        neg = cv > U(half)
        for y in range(geo["groups"]):
            for l in range(y * lpt, min(L, y * lpt + lpt)):
                r = jm.barrett_reduce_64(cv, p[l], r1[l])
                out[b, l, col] = np.where(neg, jm.reduce_once(r + pq[l], p[l]), r)
                writes[b, l, col] += 1
    return out, writes


@pytest.mark.parametrize("n,bits,lead,geo", [
    (4096, None, (2,), None),            # bench_all.py's N=4096 refresh: [2, 1, 4096] -> 21
    (64, [59, 40, 40, 41, 59], (3, 2), None),
    (1024, [59, 45, 45, 59], (1,), None),
    (2, [30, 31, 32], (5,), None),
    (64, [59, 40, 40, 41, 59], (2,), {"threads": 32, "lpt": 3, "log_tiles": 1}),
    (64, [59, 40, 40, 41, 59], (7,), {"threads": 256, "lpt": 4, "log_tiles": 0}),
    (1024, [59, 45, 45, 59], (3,), {"threads": 256, "lpt": 1, "log_tiles": 2})])
def test_mod_raise_threads_write_once_and_equal_jax(n, bits, lead, geo):
    """At the host's geometry, and at geometries with one and several CTAs a
    row, with CTAs wider than a row and with limb groups that do not divide
    L; N=2 puts a row in one CTA of 32."""
    if bits is None:
        bits = jb.plan_bootstrap_chain(4096, radix=4, nsp=3, restored=2)[0][:-2]
    (jc, jtop, jlast, jplan), (_, ttop, _, tplan) = _plans(n, bits)
    if n == 4096:
        assert len(jtop.parms.coeff_modulus) == 21
    q0, L = tplan.q0, len(ttop.parms.coeff_modulus)
    rng = np.random.default_rng(n + L)
    c = rng.integers(0, q0, size=lead + (1, n), dtype=U)
    flat = c.reshape(-1)
    pins = [0, 1, (q0 >> 1) - 1, q0 >> 1, (q0 >> 1) + 1, q0 - 1]
    flat[:len(pins)] = pins[:flat.size]
    flat[-len(pins):] = pins[::-1][-flat.size:]
    # the JAX package's mod_raise (inverse NTT, lift, forward NTT) on numpy,
    # and its top-level inverse NTT: the lift itself
    want = jntt_inverse(jb.mod_raise(jntt_forward(c, jlast.ntt_tables), jplan),
                        jtop.ntt_tables)
    B = c.size // n
    k = tmr.mod_raise_constants(to_numpy(tplan.p), to_numpy(tplan.ratio1),
                                to_numpy(tplan.q0_mod_p))
    if geo is None:
        geo = tmr.mod_raise_geometry(B, L, n)
        if n == 4096:  # the refresh spreads over the card: 6 groups of 4 limbs, 384 CTAs
            assert (geo["lpt"], geo["groups"], B << geo["log_tiles"]) == (4, 6, 64)
    else:
        geo = dict(geo, groups=-(-L // geo["lpt"]))
    got, writes = _k8_threads(geo, B, L, n, c.reshape(B, n), k, tplan.half)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    plain = tmr.mod_raise_lift_plain(to_tensor(c, "cpu"), tplan.p, tplan.ratio1,
                                     tplan.q0_mod_p, tplan.half)
    np.testing.assert_array_equal(to_numpy(plain), want)


@pytest.mark.parametrize("B,L,N", [(2, 21, 4096), (8, 21, 4096), (2, 21, 8192), (2, 64, 65536),
                                   (1, 1, 2), (3, 5, 64), (70000, 3, 64), (1, 64, 1024),
                                   (1, 1, 1)])
def test_mod_raise_geometry_fits_the_kernel(B, L, N):
    geo = tmr.mod_raise_geometry(B, L, N)
    threads, lt = geo["threads"], geo["log_tiles"]
    assert 32 <= threads <= 256 and threads % 32 == 0
    assert threads << lt >= N and (lt == 0 or threads << (lt - 1) < N)
    assert 1 <= geo["lpt"] <= L and (geo["groups"] - 1) * geo["lpt"] < L
    assert geo["groups"] * geo["lpt"] >= L and geo["groups"] <= 65535
    ctas = (B << lt) * geo["groups"]
    assert ctas >= min(384, (B << lt) * L) or geo["lpt"] <= 3   # the card is filled


# --- K9: constants


def _jlimbs(mods):
    return jd.LimbConstants.from_moduli(mods)


def test_negacyclic_constants_match_the_jax_limbs():
    mods = get_primes(4096, 36, 2) + get_primes(4096, 60, 1)
    jl, tl = _jlimbs(mods), td.LimbConstants.from_moduli(mods, "cpu")
    got = td.negacyclic_constants(to_numpy(tl.p), to_numpy(tl.ratio0), to_numpy(tl.ratio1))
    np.testing.assert_array_equal(got, np.concatenate([jl.p, jl.ratio0, jl.ratio1]).reshape(-1))


@pytest.mark.parametrize("bits", [30, 36, 50, 60])
def test_negacyclic_shoup_constants_equal_the_jax_mul_mod(bits):
    """w = c mod p and its Shoup constant, host-computed for a scalar c, at
    c in {0, 1, p - 1, p, 2p - 1} of each limb: w below p, the constant the
    JAX NTT's floor(w 2^64 / p), and the Shoup product (JAX mul_mod_shoup)
    the JAX Barrett mul_mod by c itself on 0, 1, p - 1 and random inputs."""
    mods = get_primes(1024, bits, 3)
    jl = _jlimbs(mods)
    rng = np.random.default_rng(bits)
    for p in mods:
        for c in (0, 1, p - 1, p, 2 * p - 1):
            k = td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1, c)
            L = len(mods)
            w, ws = k[L:2 * L], k[2 * L:]
            np.testing.assert_array_equal(k[:L], jl.p.reshape(-1))
            assert [int(v) for v in w] == [c % int(q) for q in mods]
            assert all(int(a) < int(q) for a, q in zip(w, mods))
            assert [int(v) for v in ws] == [_shoupify(int(a), int(q)) for a, q in zip(w, mods)]
            x = np.stack([np.concatenate([np.array([0, 1, q - 1], dtype=U),
                                          rng.integers(0, q, 29, dtype=U)]) for q in mods])
            got = jm.mul_mod_shoup(x, w.reshape(-1, 1), ws.reshape(-1, 1), jl.p)
            want = jm.mul_mod(x, np.full_like(x, U(c)), jl.p, jl.ratio0, jl.ratio1)
            np.testing.assert_array_equal(got, want)


def test_negacyclic_constants_cap():
    mods = get_primes(1024, 40, 65)
    jl = _jlimbs(mods)
    assert td.negacyclic_constants(jl.p[:64], jl.ratio0[:64], jl.ratio1[:64]).size == 192
    with pytest.raises(ValueError, match="1 to 64 moduli"):
        td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1)
    with pytest.raises(ValueError, match="1 to 64 moduli"):
        td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1, 4)


# --- K9: geometry and threads

FORMS = {"shift": 0, "barrett_limb": 1, "shoup": 2}


def _k9_threads(geo, form, R, L, N, a, k_consts, k, col=None):
    """csrc/negacyclic.cu's threads over the whole grid: (out, writes).
    Grid x: R << log_tiles CTAs (the row and the tile by a shift and a
    mask), y: the limb; one thread an output."""
    threads, lt = geo["threads"], geo["log_tiles"]
    mask = N - 1
    rot, odd = k & mask, k >> (N.bit_length() - 1)
    out = np.zeros((R, L, N), dtype=U)
    writes = np.zeros((R, L, N), dtype=np.int64)
    k0, k1, k2 = k_consts[:L], k_consts[L:2 * L], k_consts[2 * L:]
    rows = np.arange(R)                                  # every row's CTAs, at once
    for l in range(L):                                   # grid y
        p = k0[l]
        src = a[:, l]
        for tile in range(1 << lt):
            j = tile * threads + np.arange(threads)
            j = j[j <= mask]                             # the live threads
            x = src[:, (j - rot) & mask]
            if form == FORMS["barrett_limb"]:
                x = jm.mul_mod(x, np.full_like(x, U(col[l])), p, k1[l], k2[l])
            elif form == FORMS["shoup"]:
                x = jm.mul_mod_shoup(x, k1[l], k2[l], p)
            x = np.where((j < rot) != bool(odd), jm.neg_mod(x, p), x)
            out[rows[:, None], l, j[None, :]] = x
            np.add.at(writes, (rows[:, None], l, j[None, :]), 1)
    return out, writes


def _k9_case(N, R, L, seed):
    mods = get_primes(N, 60, 1) + (get_primes(N, 40, L - 1) if L > 1 else [])
    rng = np.random.default_rng(seed)
    a = np.stack([rng.integers(0, p, size=(R, N), dtype=U) for p in mods], axis=1)
    a[..., ::5] = 0
    return mods, a


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("N,R,L,geo", [
    (4096, 2, 2, None),                  # ex1's multiply_plain: [2, 2, 4096]
    (2, 3, 2, None),
    (64, 3, 3, None),                    # rows and a row that do not fill a CTA of 256
    (1024, 1, 2, None),
    (1024, 2, 2, {"threads": 64, "log_tiles": 4}),
    (64, 5, 2, {"threads": 32, "log_tiles": 1})])
def test_negacyclic_threads_write_once_and_equal_jax(form, N, R, L, geo):
    """Every k edge, each form against the JAX negacyclic_shift_poly or
    negacyclic_mono_mul_poly on numpy: the Barrett product by a per-limb
    coefficient p - 1 and 2p - 1, the Shoup product by a scalar 4 (ex1's
    "4"), p_0 - 1 and 2 p_L - 1, with its host-reduced constants."""
    mods, a = _k9_case(N, R, L, N * R + L)
    jl = _jlimbs(mods)
    base = td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1)
    if geo is None:
        geo = td.negacyclic_geometry(N)
    for k in sorted({0, 1, N - 1, N, N + 1, 2 * N - 1}):
        cases = []
        if form == "shift" and k:        # x^0 returns its input without a launch
            cases.append(((base,), jd.negacyclic_shift_poly(a, k, jl)))
        if form == "barrett_limb":
            for f in (lambda p: p - 1, lambda p: 2 * p - 1):
                col = np.array([f(p) for p in mods], dtype=U)
                cases.append(((base, col),
                              jd.negacyclic_mono_mul_poly(a, col.reshape(-1, 1), k, jl)))
        if form == "shoup":
            for c in (4, mods[0] - 1, 2 * mods[-1] - 1):
                consts = td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1, c)
                cases.append(((consts,),
                              jd.negacyclic_mono_mul_poly(a, np.full((L, 1), c, dtype=U), k,
                                                          jl)))
        for args, want in cases:
            got, writes = _k9_threads(geo, FORMS[form], R, L, N, a, args[0], k,
                                      col=args[1] if len(args) > 1 else None)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, want)


def test_negacyclic_many_rows():
    """70,000 rows of N = 2 (more than a grid's y or z axis holds: the rows
    go on x), Shoup by 5 at x^3, and the plain version equals the JAX
    function."""
    N, R, L = 2, 70000, 1
    mods, a = _k9_case(N, R, L, 7)
    jl = _jlimbs(mods)
    geo = td.negacyclic_geometry(N)
    assert (geo["threads"], geo["log_tiles"]) == (32, 0)
    got, writes = _k9_threads(geo, FORMS["shoup"], R, L, N, a,
                              td.negacyclic_constants(jl.p, jl.ratio0, jl.ratio1, 5), 3)
    want = jd.negacyclic_mono_mul_poly(a, np.full((L, 1), 5, dtype=U), 3, jl)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    tl = td.LimbConstants.from_moduli(mods, "cpu")
    plain = td.negacyclic_mono_mul_poly(to_tensor(a, "cpu"), 5, 3, tl)
    np.testing.assert_array_equal(to_numpy(plain), want)


@pytest.mark.parametrize("N", [1, 2, 32, 64, 256, 4096, 8192, 131072])
def test_negacyclic_geometry_fits_the_kernel(N):
    geo = td.negacyclic_geometry(N)
    threads, lt = geo["threads"], geo["log_tiles"]
    assert 32 <= threads <= 256 and threads % 32 == 0
    assert threads << lt >= N and (lt == 0 or threads << (lt - 1) < N)
