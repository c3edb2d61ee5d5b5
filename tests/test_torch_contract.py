"""K3's contraction (gemini_seal_tpu_torch.ops.modops.contract_mulmod_128 and
contract_plain) against the JAX package's accumulate_mulmod_128 in every form
its callers use, the key inner product with both key components in one
contraction against the JAX key switch, and the kernel's launch geometry.

The JAX functions run eagerly on numpy inputs (the package's host-plane
dispatch): nothing is compiled.  On CPU tensors the wrapper runs its plain
version; the geometry tests emulate csrc/contract.cu's index mapping in
Python (which CTA, thread and item writes which output, and which staged
row an item reads) at the geometry that contract_geometry picks, and hold
the emulated results to contract_plain.
"""

import numpy as np
import pytest
import torch

import gemini_seal_tpu as J
import gemini_seal_tpu_torch as T
from gemini_seal_tpu.modulus import Modulus as JModulus
from gemini_seal_tpu.ops import keyswitch as jk
from gemini_seal_tpu.ops import modops as jm
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import keyswitch as tk
from gemini_seal_tpu_torch.ops import modops as tm
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

N = 256


def _limbs(mods):
    """(p, r0, r1) as np.uint64 [len(mods)]."""
    ms = [JModulus(q) for q in mods]
    return tuple(np.array(v, dtype=np.uint64) for v in (
        mods, [m.const_ratio[0] for m in ms], [m.const_ratio[1] for m in ms]))


def _jax_contract(a, w, p, r0, r1, prescale=None):
    """The JAX call sites' form: the pre-scale mul_mod, then
    accumulate_mulmod_128 over the K terms of a [..., Ga, K, Ja, N] against
    w [G, K, J, Nw]."""
    G, K, Jw, _ = w.shape
    if prescale is not None:
        s, q, q0, q1 = (v.reshape(G, K, 1, 1) for v in prescale)
        a = jm.mul_mod(a, s, q, q0, q1)
    pj, pr0, pr1 = (v.reshape(Jw, 1) for v in (p, r0, r1))
    return np.asarray(jm.accumulate_mulmod_128(
        ((a[..., k, :, :], w[:, k]) for k in range(K)), pj, pr0, pr1))


def _form(name, rng):
    """(a, w, out moduli, prescale or None) of one form of K3's call sites, at
    N=256 and a batch of 2."""
    ext = [get_primes(1024, b, 2)[i] for b, i in ((50, 0), (40, 0), (40, 1), (60, 0))]
    J_ = len(ext)

    def res(shape, hi):
        """values below hi (broadcast against shape)"""
        hi = np.broadcast_to(np.asarray(hi, dtype=np.uint64), shape)
        return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) % hi

    def col(mods, ndim, axis):
        """mods along `axis` of an ndim-dimensional broadcast shape"""
        shape = [1] * ndim
        shape[axis] = -1
        return np.array(mods, dtype=np.uint64).reshape(shape)

    if name == "modup":          # [B, nb, s_max, 1, N] x [nb, s_max, n_ext, 1], pre-scaled
        nb, s_max = 3, 2
        qs = [ext[(g * s_max + k) % 3] for g in range(nb) for k in range(s_max)]
        qq, q0, q1 = _limbs(qs)
        pre = tuple(v.reshape(nb, s_max) for v in (res((nb * s_max,), qq), qq, q0, q1))
        a = res((2, nb, s_max, 1, N), qq.reshape(1, nb, s_max, 1, 1))
        return a, res((nb, s_max, J_, 1), col(ext, 4, -2)), ext, pre
    if name == "key_pair":       # both key components: [B, 1, nb, n_ext, N] x [2, nb, n_ext, N]
        return (res((2, 1, 3, J_, N), 4 * col(ext, 5, -2)), res((2, 3, J_, N), col(ext, 4, -2)),
                ext, None)
    if name == "keys_hoisted":   # [B, R, nb, n_ext, N] x [R, nb, n_ext, N]
        return (res((2, 5, 3, J_, N), col(ext, 5, -2)), res((5, 3, J_, N), col(ext, 4, -2)),
                ext, None)
    if name == "keys_broadcast":  # the shared digits: [B, 1, nb, n_ext, N] x [R, ...]
        return (res((2, 1, 3, J_, N), col(ext, 5, -2)), res((5, 3, J_, N), col(ext, 4, -2)),
                ext, None)
    if name in ("dot", "dot_prescaled", "dot_m_tilde"):  # _dot_mod_128: [B, 1, I, 1, N] x [1, I, O, 1]
        ib = ext[:3] + [get_primes(1024, 50, 3)[2]]
        out = [1 << 32] if name == "dot_m_tilde" else ext[:3]
        a = res((2, 1, len(ib), 1, N), col(ib, 5, -3))
        w = res((1, len(ib), len(out), 1), col(out, 4, -2))
        pre = None
        if name == "dot_prescaled":
            qq, q0, q1 = _limbs(ib)
            pre = tuple(v.reshape(1, len(ib)) for v in (res((len(ib),), qq), qq, q0, q1))
        return a, w, out, pre
    if name == "group_m":        # the matvecs' weighted sums: [B, G, K, L, N] x [G, K, L, N]
        return (res((2, 2, 7, 3, N), col(ext[:3], 5, -2)), res((2, 7, 3, N), col(ext[:3], 4, -2)),
                ext[:3], None)
    if name == "sum_rows":       # _sum_rows: [B, 1, K, L, N] x ones [1, K, L, 1]
        return (res((2, 1, 8, 3, N), col(ext[:3], 5, -2)), np.ones((1, 8, 3, 1), dtype=np.uint64),
                ext[:3], None)
    if name == "broadcast_prescaled":  # one input pre-scaled for each group
        qq, q0, q1 = _limbs(ext[:2] * 3)
        pre = tuple(v.reshape(3, 2) for v in (res((6,), qq), qq, q0, q1))
        return (res((2, 1, 2, 1, N), col(ext[:2], 5, -3)), res((3, 2, J_, 1), col(ext, 4, -2)),
                ext, pre)
    raise ValueError(name)


FORMS = ["modup", "key_pair", "keys_hoisted", "keys_broadcast", "dot", "dot_prescaled",
         "dot_m_tilde", "group_m", "sum_rows", "broadcast_prescaled"]


def _torch_args(a, w, mods, pre):
    p, r0, r1 = _limbs(mods)
    tt = (lambda v: to_tensor(v, "cpu"))
    return (tt(a), tt(w), tt(p), tt(r0), tt(r1)), (
        None if pre is None else tuple(tt(v) for v in pre))


@pytest.mark.parametrize("form", FORMS)
def test_contract_forms_match_jax(form):
    a, w, mods, pre = _form(form, np.random.default_rng(FORMS.index(form)))
    want = _jax_contract(a, w, *_limbs(mods), prescale=pre)
    args, tpre = _torch_args(a, w, mods, pre)
    for fn in (tm.contract_plain, tm.contract_mulmod_128):
        got = fn(*args, prescale=tpre)
        assert got.shape == want.shape
        np.testing.assert_array_equal(to_numpy(got), want)


def test_contract_top_of_lazy_range_at_largest_k():
    """Inputs at 4p - 1 and weights at p - 1, at the largest number of terms
    that KeySwitchPlan.lazy_digits admits for a 60-bit prime: the sum sits
    just below 2^128."""
    p = get_primes(1024, 60, 1)[0]
    K = ((1 << 128) - 1) // (4 * p * p)
    assert jk.KeySwitchPlan._lazy_digits_safe(K, p) and not jk.KeySwitchPlan._lazy_digits_safe(
        K + 1, p)
    a = np.full((1, 1, K, 1, 16), 4 * p - 1, dtype=np.uint64)
    w = np.full((1, K, 1, 1), p - 1, dtype=np.uint64)
    total = K * (4 * p - 1) * (p - 1)
    assert total < 1 << 128
    want = _jax_contract(a, w, *_limbs([p]))
    assert int(want[0, 0, 0, 0]) == total % p
    args, _ = _torch_args(a, w, [p], None)
    for fn in (tm.contract_plain, tm.contract_mulmod_128):
        np.testing.assert_array_equal(to_numpy(fn(*args)), want)


# --- both key components in one contraction


def _contexts(bits, nsp, n=64):
    out = []
    for M, kw in ((J, {}), (T, {"device": "cpu"})):
        parms = M.EncryptionParameters(M.SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(M.CoeffModulus.create(n, bits))
        parms.set_n_special_primes(nsp)
        out.append(M.SealContext(parms, sec_level=M.SecLevelType.none, **kw))
    return out


@pytest.mark.parametrize("bits,nsp", [([40, 30, 30, 40], 1), ([40, 30, 30, 40, 40], 2)])
@pytest.mark.parametrize("is_ntt", [True, False])
def test_keyswitch_inner_product_one_contraction(monkeypatch, bits, nsp, is_ntt):
    """keyswitch_inner_product makes one contract call for both key
    components (the digits broadcast over a [2, nb, n_ext, N] key), and its
    raw and rescaled outputs equal the JAX function's (numpy inputs, eager)."""
    jctx, tctx = _contexts(bits, nsp)
    pid = jctx.first_parms_id
    jplan, tplan = jk.KeySwitchPlan(jctx, pid), tk.KeySwitchPlan(tctx, pid)
    rng = np.random.default_rng(sum(bits) + nsp)
    n = 64
    key_mods = [m.value for m in jctx.key_context_data().parms.coeff_modulus]
    key = np.stack([np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64)
                              for q in key_mods], axis=1) for _ in range(jplan.n_bundles)])
    digits = np.stack([rng.integers(0, 4 * q if jplan.lazy_digits else q, size=(2, jplan.n_bundles, n),
                                    dtype=np.uint64) for q in jplan.ext_moduli], axis=-2)
    calls = []
    real = tk.contract_mulmod_128

    def counted(a, w, *args, **kwargs):
        calls.append((tuple(a.shape), tuple(w.shape)))
        return real(a, w, *args, **kwargs)

    monkeypatch.setattr(tk, "contract_mulmod_128", counted)
    td, tkey = to_tensor(digits, "cpu"), to_tensor(key, "cpu")
    for raw in (True, False):
        calls.clear()
        want = jk.keyswitch_inner_product(digits, key, jplan, is_ntt, raw=raw)
        got = tk.keyswitch_inner_product(td, tkey, tplan, is_ntt, raw=raw)
        inner = [c for c in calls if c[1][0] == 2]
        assert len(inner) == 1 and inner[0][0][-4] == 1      # one broadcast contraction
        for wv, gv in zip(want, got):
            np.testing.assert_array_equal(np.asarray(wv), to_numpy(gv))


# --- the launch geometry, emulated


def _items(geo, J_, slice_):
    """The (gi, j) items of one thread slice, by the kernel's own stepping."""
    slices = geo["threads"] // geo["tile"]
    sdiv, smod = slices // J_, slices % J_
    gi, j = slice_ // J_, slice_ % J_
    out = []
    while gi < geo["ng"]:
        out.append((gi, j))
        j += smod
        gi += sdiv
        if j >= J_:
            j -= J_
            gi += 1
    return out


def _emulate(a, w, p, prescale, geo, R, Ga, G, K, J_, Ja, N, Nw):
    """csrc/contract.cu's mapping in Python: returns (out [R*G*J*N] ints, the
    number of writes of each output).  a, w: flat lists of ints."""
    tp, vec, T_ = geo["tile"], geo["vec"], geo["threads"]
    units = N // vec
    slices = T_ // tp
    a_row, a_group = Ga * K * Ja * N, (0 if Ga == 1 else K * Ja * N)
    wn = N if Nw > 1 else 1
    out = [None] * (R * G * J_ * N)
    writes = [0] * (R * G * J_ * N)
    rows = [r for y in range(geo["grid_y"]) for r in range(y, R, geo["grid_y"])]
    assert sorted(rows) == list(range(R))
    for r in rows:
        for z in range(geo["z_count"]):
            g0 = 0 if geo["ng"] > 1 else z
            for x in range(geo["tiles"]):
                stage = {}

                def pre(v, k):
                    if prescale is None:
                        return v
                    return v * prescale[0][z * K + k] % prescale[1][z * K + k]

                def load(q, unit, e):
                    return a[r * a_row + z * a_group + q * N + unit * vec + e]

                if geo["staged"]:
                    for t in range(T_):
                        u, sl = t % tp, t // tp
                        unit = x * tp + u
                        if unit >= units:
                            continue
                        for q in range(sl, K * Ja, slices):
                            for e in range(vec):
                                assert (q, u, e) not in stage
                                stage[(q, u, e)] = pre(load(q, unit, e), q if Ja == 1 else q // Ja)
                for t in range(T_):
                    u, sl = t % tp, t // tp
                    unit = x * tp + u
                    if unit >= units:
                        continue
                    for gi, j in _items(geo, J_, sl):
                        g = g0 + gi
                        for e in range(vec):
                            acc = 0
                            for k in range(K):
                                q = k * Ja + (j if Ja > 1 else 0)
                                xv = stage[(q, u, e)] if geo["staged"] else pre(
                                    load(q, unit, e), k)
                                wv = w[((g * K + k) * J_ + j) * wn + (unit * vec + e if Nw > 1
                                                                       else 0)]
                                acc += xv * wv
                            assert acc < 1 << 128
                            idx = ((r * G + g) * J_ + j) * N + unit * vec + e
                            out[idx] = acc % p[j]
                            writes[idx] += 1
    return out, writes


# (R, Ga, G, K, J, Ja, N, Nw, prescale): each form, rows shorter than a
# tile, a single row, odd N (16-byte units off)
GEOMETRY_CASES = [
    (3, 3, 3, 2, 4, 1, 32, 1, True),     # mod-up
    (2, 1, 2, 3, 4, 4, 16, 16, False),   # both key components
    (2, 4, 4, 3, 2, 2, 16, 16, False),   # hoisted keys
    (1, 1, 5, 2, 3, 3, 8, 8, False),     # shared digits, one row
    (2, 1, 1, 4, 3, 1, 64, 1, True),     # _dot_mod_128
    (1, 1, 1, 5, 1, 1, 2, 1, False),     # N = 2: a row shorter than any tile
    (2, 1, 3, 2, 4, 1, 6, 1, True),      # broadcast with a pre-scale, N not a power of two
    (1, 2, 2, 2, 3, 3, 7, 7, False),     # odd N: one coefficient a unit
    (2, 2, 2, 3, 4, 4, 8, 8, True),      # a pre-scale with Ja = J, read directly
    (3, 1, 1, 3, 1, 1, 16, 1, True),     # one output an input: read directly
]


@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_contract_geometry_emulated(case):
    R, Ga, G, K, J_, Ja, N, Nw, pre = case
    vec = 2 if N % 2 == 0 else 1
    geo = tm.contract_geometry(R, Ga, G, K, J_, Ja, N, Nw, pre, vec)
    rng = np.random.default_rng(sum(case[:-1]))
    mods = get_primes(1024, 40, J_)
    a = rng.integers(0, 1 << 40, size=(R, Ga, K, Ja, N), dtype=np.uint64)
    w = rng.integers(0, 1 << 40, size=(G, K, J_, Nw), dtype=np.uint64)
    prescale = None
    if pre:
        qs = get_primes(1024, 30, G * K)
        qq, q0, q1 = _limbs(qs)
        prescale = (rng.integers(0, 1 << 30, size=G * K, dtype=np.uint64), qq, q0, q1)
    out, writes = _emulate([int(v) for v in a.ravel()], [int(v) for v in w.ravel()], mods,
                           None if prescale is None else [[int(v) for v in prescale[0]],
                                                          [int(v) for v in prescale[1]]],
                           geo, R, Ga, G, K, J_, Ja, N, Nw)
    assert writes == [1] * len(writes)
    args, tpre = _torch_args(a, w, mods, None if prescale is None else
                             tuple(v.reshape(G, K) for v in prescale))
    want = to_numpy(tm.contract_plain(*args, prescale=tpre)).ravel()
    assert [int(v) for v in want] == out


@pytest.mark.parametrize("shape", [
    # (R, Ga, G, K, J, Ja, N, Nw, prescale): the main paths' shapes at full size
    (128, 3, 3, 1, 4, 1, 8192, 1, True),         # mod-up, fused step
    (128, 1, 2, 3, 4, 4, 8192, 8192, False),     # both key components, fused step
    (16, 1, 8, 3, 4, 4, 8192, 8192, False),      # shared digits, rotate-many
    (128, 1, 1, 2, 2, 1, 8192, 1, True),         # fused_moddown
    (1, 1, 2, 8, 24, 24, 4096, 4096, False),     # the refresh's key inner product
    (1, 8, 8, 3, 27, 1, 4096, 1, True),          # the refresh's mod-up
    (128, 1, 1, 64, 1, 1, 16, 1, False),         # many terms, short rows
    (70000, 1, 1, 2, 3, 1, 2, 1, False),         # more rows than the grid's y axis holds
])
def test_contract_geometry_covers_every_output_once(shape):
    """At the main paths' shapes: every output unit is written by exactly one
    (CTA, thread, item), every staged row that an item reads is staged by
    exactly one thread, and the geometry fits the kernel's limits."""
    R, Ga, G, K, J_, Ja, N, Nw, pre = shape
    geo = tm.contract_geometry(R, Ga, G, K, J_, Ja, N, Nw, pre, 2)
    tp, T_ = geo["tile"], geo["threads"]
    assert T_ % tp == 0 and T_ <= 256 and geo["smem"] <= 48 * 1024
    assert geo["ng"] * geo["z_count"] == G
    slices = T_ // tp
    units = N // 2
    # items: the slices' (gi, j) sets partition range(ng) x range(J)
    seen = [it for sl in range(slices) for it in _items(geo, J_, sl)]
    assert sorted(seen) == [(gi, j) for gi in range(geo["ng"]) for j in range(J_)]
    # staging: the slices' rows partition range(K * Ja), and the tiles the units
    rows = sorted(q for sl in range(slices) for q in range(sl, K * Ja, slices))
    assert rows == list(range(K * Ja))
    cover = np.zeros(units, dtype=np.int64)
    for x in range(geo["tiles"]):
        u = x * tp + np.arange(tp)
        np.add.at(cover, u[u < units], 1)
    assert (cover == 1).all()
    # the grid: rows on y (a CTA steps by gridDim.y), input groups on z
    assert geo["z_count"] <= 65535 and 1 <= geo["grid_y"] <= min(R, 65535)
    rows = np.zeros(R, dtype=np.int64)
    for y in range(geo["grid_y"]):
        rows[y::geo["grid_y"]] += 1
    assert (rows == 1).all()


def test_contract_geometry_spreads_small_calls():
    """A call of one row still spreads its outputs: at the refresh's mod-up
    (batch 1) every thread holds at most two items; a large call keeps wide
    tiles."""
    small = tm.contract_geometry(1, 8, 8, 3, 27, 1, 4096, 1, True, 2)
    threads = small["tiles"] * small["z_count"] * small["threads"]
    assert threads * 2 >= 8 * 27 * 2048
    large = tm.contract_geometry(128, 3, 3, 1, 4, 1, 8192, 1, True, 2)
    assert large["tile"] == 256 and large["threads"] == 256
    # the Shoup constants pay for themselves only over several waves of CTAs
    assert large["shoup"] and not small["shoup"]
    # staged where an input feeds several outputs, read directly where one
    assert large["staged"] and tm.contract_geometry(
        128, 1, 2, 3, 4, 4, 8192, 8192, False, 2)["staged"]
    assert not tm.contract_geometry(16, 8, 8, 3, 4, 4, 8192, 8192, False, 2)["staged"]


def test_contract_rejects_shapes_it_cannot_take():
    a = torch.zeros((2, 3, 2, 1, 8), dtype=torch.int64)
    w = torch.zeros((2, 2, 4, 1), dtype=torch.int64)
    p = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tm.contract_mulmod_128(a, w, p, p, p)
    with pytest.raises(ValueError):     # staged input rows beyond a CTA's shared memory
        tm.contract_geometry(1, 1, 1, 4096, 2, 1, 64, 64, False, 2)
    with pytest.raises(ValueError):     # constant weights beyond a CTA's shared memory
        tm.contract_geometry(1, 1, 1, 64, 96, 1, 64, 1, False, 2)
