"""The port's four-step int8 NTT (gemini_seal_tpu_torch.ops.ntt_mxu) and
mul_mod_shoup against the JAX package.

The JAX functions run on numpy inputs (their host branch, np.einsum), so
nothing is compiled.  Tables equal field by field for the moduli of
tools/bench_ntt_mxu.py's two shapes, built at N=1024 with the same bit
sizes; the digit split exact on 56-bit values; mul_mod_shoup at its boundary
values; the forward and inverse transforms (the plain versions, the CPU path
of kernel ``ntt_mxu``) equal bit for bit to the JAX transforms and to the
port's radix-2 NTT at the JAX tests' rings, on lazy [0, 2p) inputs; and the
builder's rejection of an oversized modulus with the JAX text.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gemini_seal_tpu.modulus import CoeffModulus, Modulus
from gemini_seal_tpu.ops import modops as jmod
from gemini_seal_tpu.ops import ntt_mxu as jmx
from gemini_seal_tpu.utils.numth import get_primes
from gemini_seal_tpu_torch.ops import modops as tmod
from gemini_seal_tpu_torch.ops import ntt as tn
from gemini_seal_tpu_torch.ops import ntt_mxu as tmx
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import contiguous_calls, one_torch_thread  # noqa: F401

# tools/bench_ntt_mxu.py's moduli: config 4's ring and the headline ring
TOOL_BITS = {"n16384": [50, 40, 40, 40, 40, 50], "n8192": [50, 40, 40, 50]}


def _host(t):
    return t.numpy() if t.dtype == torch.int8 else to_numpy(t)


@pytest.mark.parametrize("shape", sorted(TOOL_BITS))
def test_tables_equal(shape):
    mods = CoeffModulus.create(1024, TOOL_BITS[shape])
    j = jmx.build_mxu_ntt_tables(10, mods)
    t = tmx.build_mxu_ntt_tables(10, [m.value for m in mods], device="cpu")
    # the port's tables hold the JAX fields in the JAX order, then the
    # kernel's per-limb digit counts (test_limb_digit_counts)
    names = [f.name for f in dataclasses.fields(t)]
    assert names == [f.name for f in dataclasses.fields(j)] + ["limb_ndig_w", "limb_ndig_x"]
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            b = _host(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_digit_split_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 56, 100, dtype=np.uint64)
    x[:3] = [0, (1 << 56) - 1, 0x8080808080808]
    want = jmx._balanced_digits_dev(x, 8, np)
    got = tmx._balanced_digits_dev(to_tensor(x, "cpu"), 8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.zeros(100, dtype=object)
    for d in range(8):
        back += got.numpy()[d].astype(object) * (256 ** d)
    assert all(int(b) == int(v) for b, v in zip(back, x))


@pytest.mark.parametrize("bits", [50, 60])
def test_mul_mod_shoup_boundaries(bits):
    p = get_primes(1024, bits, 1)[0]
    xs = np.array([0, 1, p - 1, p, 2 * p - 1, (1 << 64) - 1], dtype=np.uint64)
    ws = np.array([0, 1, 2, p - 2, p - 1, p // 3], dtype=np.uint64)
    x, w = (a.ravel() for a in np.meshgrid(xs, ws))
    ws_shoup = np.array([((int(v) << 64) // p) & ((1 << 64) - 1) for v in w], dtype=np.uint64)
    pv = np.full_like(x, p)
    want = jmod.mul_mod_shoup(x, w, ws_shoup, pv)
    got = tmod.mul_mod_shoup(*(to_tensor(a, "cpu") for a in (x, w, ws_shoup, pv)))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert (want < p).all()


@pytest.mark.parametrize("log_n,bits", [(4, [30, 30]), (6, [36, 36]), (8, [50, 50]),
                                        (10, [54, 54]), (10, [50, 40])])
def test_transforms_equal(log_n, bits):
    """Forward and inverse on lazy [0, 2p) inputs (2p - 1 and 0 included),
    a batch of three in front of the limb axis: equal to the JAX host
    transforms and to the port's radix-2 NTT (plain K1)."""
    n = 1 << log_n
    mods = CoeffModulus.create(max(n, 1024), bits)
    vals = [m.value for m in mods]
    j = jmx.build_mxu_ntt_tables(log_n, mods)
    t = tmx.build_mxu_ntt_tables(log_n, vals, device="cpu")
    k1 = tn.build_ntt_tables(log_n, vals).to("cpu")
    rng = np.random.default_rng(42 + log_n + bits[-1])
    x = np.stack([rng.integers(0, 2 * p, (3, n), dtype=np.uint64) for p in vals], axis=1)
    x[0, :, 0] = [2 * p - 1 for p in vals]
    x[1, :, -1] = 0
    xt = to_tensor(x, "cpu")
    with contiguous_calls():  # what the kernel demands of each pass's tensors
        fwd = tmx.ntt_forward_mxu(xt, t)
        inv = tmx.ntt_inverse_mxu(xt, t)
    np.testing.assert_array_equal(to_numpy(fwd), jmx.ntt_forward_mxu(x, j))
    np.testing.assert_array_equal(to_numpy(inv), jmx.ntt_inverse_mxu(x, j))
    assert torch.equal(fwd, tn.ntt_forward(xt, k1))
    assert torch.equal(inv, tn.ntt_inverse(xt, k1))
    canon = np.stack([x[:, li] % p for li, p in enumerate(vals)], axis=1)
    assert torch.equal(tmx.ntt_inverse_mxu(fwd, t), to_tensor(canon, "cpu"))


def test_pass_twist_epilogue_equal():
    """One pass with the twist epilogue (the kernel's first launch of each
    direction) against the JAX pass followed by its mul_mod_shoup, on a
    batch shape of five by three."""
    mods = CoeffModulus.create(1024, [50, 40])
    vals = [m.value for m in mods]
    j = jmx.build_mxu_ntt_tables(9, mods)
    t = tmx.build_mxu_ntt_tables(9, vals, device="cpu")
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(0, 2 * p, (5, 3, j.n1, j.n2), dtype=np.uint64) for p in vals],
                 axis=2)
    p3 = j.modulus[:, None, None]
    want = jmod.mul_mod_shoup(jmx._pass(x, j.fwd_col, j, "A", np), j.fwd_twist,
                              j.fwd_twist_shoup, p3)
    got = tmx.mxu_pass(to_tensor(x, "cpu"), t.fwd_col, t, "A",
                       twist=(t.fwd_twist, t.fwd_twist_shoup))
    np.testing.assert_array_equal(to_numpy(got), want)
    want_b = jmx._pass(x, j.inv_row, j, "B", np)
    got_b = tmx.mxu_pass(to_tensor(x, "cpu"), t.inv_row, t, "B")
    np.testing.assert_array_equal(to_numpy(got_b), want_b)


def test_oversized_modulus_rejected():
    big = (1 << 60) - (1 << 14) + 1
    with pytest.raises(ValueError) as jerr:
        jmx.build_mxu_ntt_tables(11, [Modulus(big)])
    with pytest.raises(ValueError) as terr:
        tmx.build_mxu_ntt_tables(11, [big], device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "128-bit MXU digit recombine" in str(terr.value)


# --------------------------------------------------------------------------
# The kernel's per-limb digit counts, its fold and its mapping (csrc/ntt_mxu.cu)
# --------------------------------------------------------------------------

_JT = ("fwd_col", "fwd_row", "inv_col", "inv_row")


def _mixed(bits, n=1024):
    pools = {b: get_primes(n, b, bits.count(b)) for b in set(bits)}
    return [pools[b].pop() for b in bits]


@pytest.mark.parametrize("bits", [(30, 40, 50, 40, 30), (50, 30), (40,)])
def test_limb_digit_counts(bits):
    """Each limb's weight count is 1 + its highest nonzero plane in each of
    the four JAX tables, every plane above it all zero; its data count is
    _digits_for_data(2 p - 1), every digit above it 0 for x in {0, 1,
    p - 1, p, 2p - 2, 2p - 1}, the digits below it summing back to x."""
    mods = _mixed(list(bits))
    j = jmx.build_mxu_ntt_tables(10, mods)
    t = tmx.build_mxu_ntt_tables(10, mods, device="cpu")
    for name in _JT:
        arr = getattr(j, name)
        for li in range(len(mods)):
            nonzero = [d for d in range(arr.shape[1]) if arr[li, d].any()]
            assert t.limb_ndig_w[name][li] == 1 + max(nonzero), (name, li)
            assert not arr[li, t.limb_ndig_w[name][li]:].any()
    assert t.limb_ndig_x == tuple(jmx._digits_for_data(2 * p - 1) for p in mods)
    # the 40-bit limbs of the tool's rings need 6 x 6 pairs, the 50-bit 7 x 7
    for li, b in enumerate(bits):
        if b in (40, 50):
            assert (t.limb_ndig_w["fwd_col"][li], t.limb_ndig_x[li]) == {40: (6, 6), 50: (7, 7)}[b]
    assert tmx.limb_counts(t.fwd_row, t) == (t.limb_ndig_w["fwd_row"], t.limb_ndig_x)
    # a tensor that is not one of the tables' skips nothing
    assert tmx.limb_counts(t.fwd_row.clone(), t) == ((t.ndig_w,) * len(mods),
                                                     (t.ndig_x,) * len(mods))


@pytest.mark.parametrize("bits", [30, 40, 50, 60])
def test_data_digits_above_count_are_zero(bits):
    """The data count's carry-free criterion at 30- to 60-bit primes (60-bit
    tables exceed the 128-bit recombine, so only the split is held here):
    the JAX split's digits at and above dx_l are 0 on [0, 2p)'s edges."""
    p = get_primes(1024, bits, 1)[0]
    dx = jmx._digits_for_data(2 * p - 1)
    xs = np.array([0, 1, p - 1, p, 2 * p - 2, 2 * p - 1], dtype=np.uint64)
    digs = jmx._balanced_digits_dev(xs, 8, np)
    assert not digs[dx:].any()
    back = sum(digs[e].astype(object) * 256 ** e for e in range(dx))
    assert [int(v) for v in back] == [int(v) for v in xs]
    if dx < 8:   # one digit fewer would not do for 2p - 1
        assert jmx._balanced_digits_dev(xs[-1:], 8, np)[dx - 1].any() or dx == 1


@pytest.mark.parametrize("bits", [(30, 40, 50, 40, 30), (50, 40)])
def test_plain_limb_pairs_equal_jax_pass(bits):
    """Summing only each limb's own digit pairs (the kernel's sum, plain)
    equals the JAX _pass bit for bit, for all four tables, with and without
    the twist."""
    mods = _mixed(list(bits))
    j = jmx.build_mxu_ntt_tables(9, mods)
    t = tmx.build_mxu_ntt_tables(9, mods, device="cpu")
    rng = np.random.default_rng(11)
    x = np.stack([rng.integers(0, 2 * p, (2, j.n1, j.n2), dtype=np.uint64) for p in mods], axis=1)
    x[0, :, 0, 0] = [2 * p - 1 for p in mods]
    xt = to_tensor(x, "cpu")
    for name, cx in zip(_JT, "ABAB"):
        want = jmx._pass(x, getattr(j, name), j, cx, np)
        got = tmx.mxu_pass_plain_limbs(xt, getattr(t, name), t, cx)
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=name)
    p3 = j.modulus[:, None, None]
    want = jmod.mul_mod_shoup(jmx._pass(x, j.fwd_col, j, "A", np), j.fwd_twist,
                              j.fwd_twist_shoup, p3)
    got = tmx.mxu_pass_plain_limbs(xt, t.fwd_col, t, "A", twist=(t.fwd_twist, t.fwd_twist_shoup))
    np.testing.assert_array_equal(to_numpy(got), want)


def _fold(planes, tables, consts):
    """The kernel's recombine on numpy: FOLD_PLANES planes a group into an
    int64 partial sum_ii plane_(G g + ii) 2^(8 ii), plus the limb's bias (a
    multiple of p, at least 2^58), times 2^(8 G g) mod p by a canonical
    Shoup product (the JAX mul_mod_shoup), added mod p into the running
    residue."""
    L, G = len(tables.modulus), tmx.FOLD_PLANES
    p = tables.modulus[:, None, None]
    bias = consts[:L][:, None, None]
    # the Shoup constant of 1 is floor(2^64 / p): the Barrett ratio's high word
    w = [np.ones(L, dtype=np.uint64)] + [consts[(1 + 2 * g) * L:(2 + 2 * g) * L]
                                        for g in range(tmx.FOLD_GROUPS - 1)]
    ws = [tables.ratio1] + [consts[(2 + 2 * g) * L:(3 + 2 * g) * L]
                            for g in range(tmx.FOLD_GROUPS - 1)]
    res = None
    for g in range(0, len(planes), G):
        part = np.zeros(planes[0].shape, dtype=np.int64)
        for ii, pl in enumerate(planes[g:g + G]):
            part = part + (pl.astype(np.int64) << np.int64(8 * ii))
        assert (np.abs(part) < (1 << 58)).all()
        u = part.view(np.uint64) + bias
        r = jmod.mul_mod_shoup(u, w[g // G][:, None, None], ws[g // G][:, None, None], p)
        res = r if res is None else jmod.add_mod(res, r, p)
    return res


def test_fold_constants():
    """The fold's by-value constants against Python integers, and the
    Shoup constant of 1 is the Barrett ratio's high word."""
    mods = _mixed([30, 40, 50, 54, 60])
    consts = tmx.fold_constants(mods)
    L, G = len(mods), tmx.FOLD_PLANES
    assert consts.dtype == np.uint64 and consts.shape == ((2 * tmx.FOLD_GROUPS - 1) * L,)
    assert G * tmx.FOLD_GROUPS >= 15
    for li, p in enumerate(mods):
        bias = int(consts[li])
        assert bias % p == 0 and (1 << 58) <= bias < (1 << 58) + p
        for g in range(1, tmx.FOLD_GROUPS):
            w = int(consts[(2 * g - 1) * L + li])
            assert w == pow(2, 8 * G * g, p) and int(consts[2 * g * L + li]) == (w << 64) // p
        assert (((1 << 128) // p) >> 64) == (1 << 64) // p


@pytest.mark.parametrize("log_n,bits", [(10, (50, 40)), (10, (54, 54)), (6, (30, 30))])
def test_group_fold_equals_jax_combine(log_n, bits):
    """The kernel's fold (int64 partials of FOLD_PLANES planes, each a Shoup
    product by 2^(8 FOLD_PLANES g) mod p into a running residue; no plane
    above 14)
    equals the JAX _combine_planes (the 128-bit ladder and one Barrett
    reduction) on the same planes, at the largest planes the lazy range
    gives (2p - 1 data) and on random data."""
    mods = _mixed(list(bits))
    j = jmx.build_mxu_ntt_tables(log_n, mods)
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, 2 * p, (3, j.n1, j.n2), dtype=np.uint64) for p in mods], axis=1)
    x[0] = np.array([2 * p - 1 for p in mods], dtype=np.uint64)[:, None, None]
    for w, cx in ((j.fwd_col, "A"), (j.inv_row, "B")):
        planes = jmx._digit_matmul(jmx._balanced_digits_dev(x, j.ndig_x, np), w, cx)
        assert len(planes) <= 15
        np.testing.assert_array_equal(_fold(planes, j, tmx.fold_constants(j.modulus)),
                                      jmx._combine_planes(planes, j, np))


@pytest.mark.parametrize("K,n,mode", [(128, 128, 0), (128, 128, 1), (128, 64, 0), (64, 128, 1),
                                      (8, 2, 0), (2, 8, 1), (16, 64, 0), (512, 128, 1),
                                      (256, 128, 1), (32, 32, 0)])
@pytest.mark.parametrize("sms", [132, 5])
def test_kernel_mapping_writes_every_output_once(K, n, mode, sms):
    """A Python emulation of csrc/ntt_mxu.cu's mapping at the launch that the
    wrapper hands it (ntt_mxu_geometry, on a card of 132 SMs and on one of
    5, where each CTA walks several items): every CTA's items and each consumer
    warpgroup's 64 x NT accumulator tile write every output of every row
    exactly once; the producer's split writes each digit plane of a stage
    once, at the offsets where the consumers' descriptors read (n, k)
    (core matrices of 8 rows x 16 bytes, SBO 128, LBO NT / 8 x 128), and
    reads each word of the raw TMA boxes (128-byte swizzle) once, every
    load and store without a bank conflict; W's resident tile holds each
    weight once where the A descriptor reads it; the shared memory fits the
    card's 227 KB."""
    R, L = 6, 3
    geo = tmx.ntt_mxu_geometry(K, n, R, L, 7, 7, mode, sms)
    nt, Kp, mt = geo["nt"], geo["Kp"], geo["mt"]
    assert nt == (32 if K <= 128 else 16) and geo["resident"] == (K <= 128)
    assert geo["smem"] <= 232448 and geo["stages"] >= 2
    assert list(tmx._host_geometry(K, n, R, L, 7, 7, mode, sms)) == \
        [geo[f] for f in tmx.GEOM_FIELDS]
    written = np.zeros((R, K, n), dtype=np.int64)   # [row, m, n]
    gx, gy = geo["grid_x"], geo["grid_y"]
    t = np.arange(128)
    w_, gq, tq = t >> 5, (t & 31) >> 2, t & 3
    for y in range(gy):
        l, mblk = y >> geo["log_mblocks"], y & ((1 << geo["log_mblocks"]) - 1)
        for x in range(gx):
            nitems = -(-(geo["items"] - x) // gx) if geo["items"] > x else 0
            for i in range(nitems):
                it = x + i * gx
                row = (it >> geo["log_ntiles"]) * L + l
                n0 = (it & ((1 << geo["log_ntiles"]) - 1)) * nt
                for c in range(2):
                    if mt == 1 and (i & 1) != c:
                        continue
                    m0 = mblk * 128 + (c if mt == 2 else 0) * 64
                    for j8 in range(nt // 8):
                        for h in range(2):
                            for c2 in range(2):
                                m = m0 + 16 * w_ + gq + 8 * h
                                col = n0 + 8 * j8 + 2 * tq + c2
                                ok = (m < K) & (col < n)
                                np.add.at(written, (row, m[ok], col[ok]), 1)
    assert (written == 1).all()
    # the producer's split: unit u of warp, lane (n_in, kq) reads x[n][k .. k + 3]
    # from the raw half (TMA boxes of 16 words a 128-byte row, the 128-byte
    # swizzle: word c of row r at chunk (c >> 1) ^ (r & 7)) and writes its
    # digit words at offset (n, k) of each plane
    plane = geo["plane_bytes"]
    seen = np.zeros(plane, dtype=np.int64)
    lane = np.arange(32)
    n_in, kq = lane & 7, lane >> 3
    box = geo["box_bytes"]
    assert box % 1024 == 0 and geo["raw_half"] == geo["boxes"] * box

    def banks(addr, width):   # the 4-byte banks of one access by a set of lanes
        return ((addr[:, None] + np.arange(0, width, 4)[None, :]) // 4 % 32).ravel()

    for h in range(2):
        raw_read = np.zeros(geo["raw_half"] // 8, dtype=np.int64)
        units = (nt // 8) * (Kp >> 5) if mode == 0 else (nt // 16) * (Kp >> 4)
        for u in range(units):
            if mode == 0:
                nb, kbl = u & (nt // 8 - 1), u // (nt // 8)
                kb = h * (Kp >> 5) + kbl
                nl = nb * 8 + n_in
                c = nl & 15
                for i in range(4):
                    r = kbl * 16 + 4 * kq + i
                    addr = (nl >> 4) * box + r * 128 + (((c >> 1) ^ (r & 7)) << 4) + (c & 1) * 8
                    np.add.at(raw_read, addr // 8, 1)
                    for half_warp in (slice(0, 16), slice(16, 32)):   # 8-byte loads
                        assert len(set(banks(addr[half_warp], 8))) == 32
            else:
                nbl, kb = u & (nt // 16 - 1), u // (nt // 16)
                nb = h * (nt // 16) + nbl
                r = nbl * 8 + n_in
                for chunk in (2 * kq, 2 * kq + 1):
                    addr = kb * box + r * 128 + ((chunk ^ (r & 7)) << 4)
                    np.add.at(raw_read, addr // 8, 1)
                    np.add.at(raw_read, addr // 8 + 1, 1)
                    for quarter in range(4):   # 16-byte loads
                        assert len(set(banks(addr[8 * quarter:8 * quarter + 8], 16))) == 32
            nn, kk = nb * 8 + n_in, kb * 16 + 4 * kq
            off = (kb * (nt // 8) + nb) * 128 + n_in * 16 + kq * 4
            assert len(set(banks(off, 4))) == 32   # the digit words' stores
            for byte in range(4):   # byte b of the word: k + b
                seen[off + byte] += 1
                # the descriptor's read of (n, k + b) at k32 step kg
                k = kk + byte
                kg, kin = k // 32, k % 32
                read = kg * 2 * (nt // 8) * 128 + (kin // 16) * (nt // 8) * 128 + \
                    (nn // 8) * 128 + (nn % 8) * 16 + kin % 16
                assert (read == off + byte).all()
        assert (raw_read == 1).all()
    assert (seen == 1).all()
    # W resident (K <= 128): the prologue's fill puts (tile, m, k) of each digit
    # at (d mt + tile) (Kp / 16) 1024 + (kb 8 + m / 8) 128 + (m % 8) 16 + k % 16,
    # every byte once, where wgmma's A descriptor (LBO 1024 along k, SBO 128
    # along m, k32 step kg at 2 kg 1024) reads it
    if geo["resident"]:
        kbs, dwl = Kp // 16, 3
        filled = np.zeros(dwl * mt * 64 * Kp, dtype=np.int64)
        u = np.arange(dwl * mt * 64 * kbs)
        mi, rest = u & 63, u >> 6
        kb, tile, d = rest % kbs, (rest // kbs) % mt, rest // (kbs * mt)
        for b in range(16):
            off = (d * mt + tile) * kbs * 1024 + (kb * 8 + (mi >> 3)) * 128 + (mi & 7) * 16 + b
            np.add.at(filled, off, 1)
            k = kb * 16 + b
            kg, kin = k // 32, k % 32
            read = (d * mt + tile) * kbs * 1024 + kg * 2048 + (kin // 16) * 1024 + \
                (mi // 8) * 128 + (mi % 8) * 16 + kin % 16
            assert (read == off).all()
        assert (filled == 1).all()
