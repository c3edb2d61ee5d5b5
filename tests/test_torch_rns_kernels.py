"""The design of K6 ``behz`` and K7 ``scale_round`` (csrc/behz.cu,
csrc/scale_round.cu) modelled on the CPU, against the port's plain versions.

- The per-CTA Shoup step: a Python model of the device functions that each
  CTA runs on its constants (the divmod_128 quotient of w:0 and its one
  correction, shoup_constant), for every Shoup multiplier of K6 and K7 at
  every level of the test contexts (each below its modulus, as the host
  checks), gives floor(w * 2^64 / p), and the Shoup product by it equals
  the port's Barrett mul_mod on planted 64-bit inputs (0, p - 1, p,
  2^64 - 1) and random ones.
- The launch geometry that the host picks (``rns_geometry``) covers every
  output exactly once at the main paths' shapes and at the edges (a
  coefficient count that is not a multiple of the tile, more rows than the
  grid's y axis), and a line-by-line Python model of each kernel's thread
  at its geometry, and at geometries that keep several rows and limbs in a
  thread, writes every output once and equals the plain version.

No JAX: the plain versions are already held to the JAX package by
tests/test_torch_behz.py.
"""

import numpy as np
import pytest

import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.ops import modops as tm
from gemini_seal_tpu_torch.ops import rnsops as tr
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

M64 = (1 << 64) - 1

# (N, coeff modulus bits, plain modulus): tests/test_torch_behz.py's ring, and
# config 3's and ex3's primes at N = 1024 under two plain moduli
RINGS = [(256, [40] * 5, "batching"), (1024, [50, 40, 40, 40, 50], 1024),
         (1024, [50, 30, 30, 50, 50], "batching")]


def _context(n, bits, t):
    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, bits))
    parms.set_plain_modulus(T.PlainModulus.batching(n, 20) if t == "batching" else t)
    parms.set_random_seed(tuple(range(8)))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device="cpu")


@pytest.fixture(scope="module")
def contexts():
    return [_context(*ring) for ring in RINGS]


def _levels(ctx):
    cd = ctx.first_context_data()
    while cd is not None:
        yield cd
        cd = cd.next_context_data


# --- the device functions, modelled on Python ints (csrc/modops.cuh)


def _hi(a, b):
    return (a * b) >> 64


def barrett_reduce_128(hi, lo, p, r0, r1):
    carry = _hi(lo, r0)
    t = lo * r1 + carry
    tmp1, tmp3 = t & M64, t >> 64
    t = hi * r0 + tmp1
    tmp1b, carry2 = t & M64, t >> 64
    tmp1c = (hi * r1 + tmp3 + carry2) & M64
    result = (lo - tmp1c * p) & M64
    return result - p if result >= p else result


def divmod_128_quotient(hi, lo, p, r0, r1):
    carry = _hi(lo, r0)
    t2_lo, t2_hi = (lo * r1) & M64, _hi(lo, r1)
    tmp1 = (t2_lo + carry) & M64
    tmp3 = t2_hi + (tmp1 < t2_lo)
    t2_lo, t2_hi = (hi * r0) & M64, _hi(hi, r0)
    tmp1b = (tmp1 + t2_lo) & M64
    carry2 = t2_hi + (tmp1b < tmp1)
    q = (hi * r1 + tmp3 + carry2) & M64
    return (q + (((lo - q * p) & M64) >= p)) & M64


def shoup_constant(w, p, r0, r1):
    q = divmod_128_quotient(w, 0, p, r0, r1)
    if ((0 - q * p) & M64) >= p:
        q += 1
    return q


def mul_mod_shoup_lazy(x, w, ws, p):
    return (x * w - _hi(x, ws) * p) & M64


def mul_mod_shoup(x, w, ws, p):
    r = mul_mod_shoup_lazy(x, w, ws, p)
    return r - p if r >= p else r


def barrett_reduce_64(x, p, r1):
    r = (x - _hi(x, r1) * p) & M64
    return r - p if r >= p else r


def add_mod(a, b, p):
    s = (a + b) & M64
    return s - p if s >= p else s


def sub_mod(a, b, p):
    return (a - b + p) & M64 if a < b else a - b


def mac128(hi, lo, a, b):
    s = (hi << 64) + lo + a * b
    return (s >> 64) & M64, s & M64


def _ratios(p):
    r = T.Modulus(p).const_ratio
    return int(r[0]), int(r[1])


def mul_mod(a, b, p, r0, r1):
    return barrett_reduce_128(*mac128(0, 0, a, b), p, r0, r1)


def _cta_constant(w, p):
    """What a CTA computes for a multiplier w < p: (w, its Shoup constant)."""
    return w, shoup_constant(w, p, *_ratios(p))


def _packed(ctx):
    """(mode, packed constants) of every K6 and K7 call at every level."""
    for cd in _levels(ctx):
        tool = cd.device_rns_tool
        yield "plain_add", cd.plain_scaling_constants
        if getattr(tool, "sm_mrq_consts", None) is not None:
            yield "sm_mrq", tool.sm_mrq_consts
            yield "sk_tail", tool.sk_tail_consts
            yield "t_gamma", tool.t_gamma_consts


def test_cta_shoup_step_equals_mul_mod(contexts):
    rng = np.random.default_rng(5)
    pairs = {(w, p) for ctx in contexts for mode, k in _packed(ctx)
             for w, p in tr.shoup_operands(mode, k)}
    assert len(pairs) > 20
    for w, p in sorted(pairs):
        r0, r1 = _ratios(p)
        assert 0 < w < p
        _, ws = _cta_constant(w, p)
        assert ws == (w << 64) // p
        xs = [0, p - 1, p, M64] + [int(v) for v in rng.integers(0, 1 << 63, 8, np.uint64) * 2]
        want = [mul_mod_shoup(x, w, ws, p) for x in xs]
        assert want == [x * w % p for x in xs]
        got = tm.mul_mod(to_tensor(np.array(xs, np.uint64), "cpu"),
                         to_tensor(np.array([w] * len(xs), np.uint64), "cpu"),
                         *(to_tensor(np.array([v], np.uint64), "cpu") for v in (p, r0, r1)))
        assert [int(v) for v in to_numpy(got)] == want


def test_shoup_operands_must_be_below_their_moduli(contexts):
    tool = contexts[0].first_context_data().device_rns_tool
    k = to_numpy(tool.sk_tail_consts).copy()
    tr.check_shoup_operands("sk_tail", to_tensor(k, "cpu"))
    L = (k.size - 4) // 4
    k[3 * L] = 0                 # prod_B mod q_0 = 0: q_0 - prod_B is not below q_0
    with pytest.raises(ValueError, match="not below"):
        tr.check_shoup_operands("sk_tail", to_tensor(k, "cpu"))


# --- the launch geometry


def _covers_once(geo, R, L, N):
    """Every (row, limb, unit) of the grid's mapping exactly once, axis by axis
    (the mapping is their product), within the kernels' own limits."""
    units = N // geo["vec"]
    assert N % geo["vec"] == 0
    assert 32 <= geo["threads"] <= 256 and geo["threads"] % 32 == 0
    assert (geo["tiles"] - 1) * geo["threads"] < units <= geo["tiles"] * geo["threads"]
    assert 1 <= geo["grid_y"] <= min(R, 65535) and 1 <= geo["grid_z"] <= min(L, 65535)
    rows = sorted(r for y in range(geo["grid_y"]) for r in range(y, R, geo["grid_y"]))
    limbs = sorted(j for z in range(geo["grid_z"]) for j in range(z, L, geo["grid_z"]))
    assert rows == list(range(R)) and limbs == list(range(L))


@pytest.mark.parametrize("R,L,N,share", [
    (256, 5, 8192, False), (384, 4, 4096, False), (3, 4, 4096, False), (1, 5, 8192, False),
    (70000, 5, 4, False), (3, 4, 4160, False), (2, 4, 4097, False),
    (1, 4, 8192, True), (3, 2, 4096, True), (128, 4, 8192, True), (128, 1, 4160, True),
    (70000, 3, 2, True)])
def test_rns_geometry_covers_every_output_once(R, L, N, share):
    for vec in ((2, 1) if N % 2 == 0 else (1,)):
        geo = tr.rns_geometry(R, L, N, vec, share_rows=share)
        _covers_once(geo, R, L, N)
        if N >= 4096:  # a call of one to three rows still spreads over the 132 SMs
            assert geo["tiles"] * geo["grid_y"] * geo["grid_z"] >= 132


def _emulate(kind, geo, R, L, N, x, k, aux=None, m=None):
    """The kernel's threads in Python: returns (out, writes per output)."""
    vec, threads = geo["vec"], geo["threads"]
    units = N // vec
    lout = 1 if kind == "t_gamma" else L
    out = np.zeros((R, lout, N), dtype=object)
    writes = np.zeros((R, lout, N), dtype=int)
    x = x.astype(object)
    for z in range(geo["grid_z"]):
        for y in range(geo["grid_y"]):
            for bx in range(geo["tiles"]):
                for tx in range(threads):
                    unit = bx * threads + tx
                    if unit >= units:
                        continue
                    cols = range(unit * vec, unit * vec + vec)
                    for col in cols:
                        for r, j, v in _thread(kind, k, x, aux, m, R, L, y, z, geo, col):
                            out[r, j, col] = v
                            writes[r, j, col] += 1
    return out, writes


def _thread(kind, k, x, aux, m, R, L, y, z, geo, c):
    """One coefficient of one thread's work, as the kernel body runs it:
    yields (row, limb, value)."""
    gy, gz, shoup = geo["grid_y"], geo["grid_z"], geo["shoup"]
    if kind == "sm_mrq":
        for r in range(y, R, gy):
            rr = (0 - int(x[r, L, c]) * k[5 * L]) & 0xFFFFFFFF
            for j in range(z, L, gz):
                p, r0, r1, pq, w = k[j], k[L + j], k[2 * L + j], k[3 * L + j], k[4 * L + j]
                rj = (rr + p - (1 << 32)) & M64 if rr >= 1 << 31 else rr
                if not shoup:  # the plain version's Barrett steps
                    acc = barrett_reduce_128(*mac128(0, int(x[r, j, c]), pq, rj), p, r0, r1)
                    yield r, j, mul_mod(acc, w, p, r0, r1)
                    continue
                # x_j * m_tilde^-1 + r * (q * m_tilde^-1), the second constant by mul_mod
                qw = mul_mod(pq, w, p, r0, r1)
                s = (mul_mod_shoup_lazy(int(x[r, j, c]), *_cta_constant(w, p), p)
                     + mul_mod_shoup_lazy(rj, *_cta_constant(qw, p), p))
                s = s - 2 * p if s >= 2 * p else s
                yield r, j, s - p if s >= p else s
    elif kind == "sk_tail":
        m_sk, ib = k[4 * L], k[4 * L + 3]
        for r in range(y, R, gy):
            d = (int(x[r, L, c]) + m_sk - int(aux[r, -1, c])) & M64
            alpha = (mul_mod_shoup(d, *_cta_constant(ib, m_sk), m_sk) if shoup
                     else mul_mod(d, ib, m_sk, k[4 * L + 1], k[4 * L + 2]))
            neg = alpha > m_sk >> 1
            a = m_sk - alpha if neg else alpha
            for j in range(z, L, gz):
                p = k[j]
                w = k[3 * L + j] if neg else (p - k[3 * L + j]) & M64
                term = (mul_mod_shoup(a, *_cta_constant(w, p), p) if shoup
                        else mul_mod(a, w, p, k[L + j], k[2 * L + j]))
                yield r, j, add_mod(int(x[r, j, c]), term, p)
    elif kind == "t_gamma":
        t, t_r1, g = k[0], k[2], k[3]
        cs = [_cta_constant(k[6], t), _cta_constant(k[7], g), _cta_constant(k[8], t)]
        for r in range(y, R, gy):
            tp = mul_mod_shoup(int(x[r, 0, c]), *cs[0], t)
            gp = mul_mod_shoup(int(x[r, 1, c]), *cs[1], g)
            dest = (add_mod(tp, barrett_reduce_64(g - gp, t, t_r1), t) if gp > g >> 1
                    else sub_mod(tp, barrett_reduce_64(gp, t, t_r1), t))
            yield r, 0, mul_mod_shoup(dest, *cs[2], t)
    else:
        t, t_r0, t_r1, q_mod_t, thresh = (k[4 * L + i] for i in range(5))
        mv = int(m[c])
        fix = divmod_128_quotient(*mac128(0, thresh, mv, q_mod_t), t, t_r0, t_r1)
        for j in range(z, L, gz):
            p, r0, r1, delta = k[j], k[L + j], k[2 * L + j], k[3 * L + j]
            inc = barrett_reduce_128(*mac128(0, fix, delta, mv), p, r0, r1)
            for r in range(y, R, gy):
                v = int(x[r, j, c])
                yield r, j, sub_mod(v, inc, p) if kind == "plain_sub" else add_mod(v, inc, p)


@pytest.mark.parametrize("kind", ["sm_mrq", "sk_tail", "plain_add", "plain_sub", "t_gamma"])
@pytest.mark.parametrize("R,N,geo", [
    (3, 20, None), (2, 7, None),
    (5, 80, {"threads": 32, "grid_y": 2, "grid_z": 2, "shoup": 1}),
    (3, 20, {"threads": 32, "grid_y": 1, "grid_z": 1, "shoup": 1}),
    (4, 12, {"threads": 32, "grid_y": 3, "grid_z": 1, "shoup": 0})])
def test_kernel_threads_write_once_and_equal_plain(contexts, kind, R, N, geo):
    """At the host's geometry (these small calls: K6's Barrett form), and
    at geometries with several rows and limbs a thread (two tiles of 32
    threads at N = 80), K6 in both forms."""
    ctx = contexts[0]
    cd = ctx.first_context_data()
    tool = cd.device_rns_tool
    rng = np.random.default_rng(R * N)

    def res(mods, rows=R):
        return np.stack([rng.integers(0, p, size=(rows, N), dtype=np.uint64) for p in mods],
                        axis=1)

    m = None
    aux = None
    if kind == "sm_mrq":
        x, consts = res(tool.host.base_Bsk_m_tilde.values()), tool.sm_mrq_consts
    elif kind == "sk_tail":
        x = res(tool.host.base_q.values() + [tool.host.m_sk.value])
        aux, consts = res(tool.host.base_Bsk.values()), tool.sk_tail_consts
    elif kind == "t_gamma":
        x = res([tool.host.t.value, tool.host.gamma.value])
        consts = tool.t_gamma_consts
    else:
        x = res([q.value for q in cd.parms.coeff_modulus])
        m = rng.integers(0, cd.parms.plain_modulus.value, size=N, dtype=np.uint64)
        m[:3] = [0, cd.parms.plain_modulus.value - 1, (cd.parms.plain_modulus.value + 1) >> 1]
        consts = cd.plain_scaling_constants
    L = x.shape[1] - (1 if kind in ("sm_mrq", "sk_tail") else 0)
    vec = 2 if N % 2 == 0 else 1
    lout = 1 if kind == "t_gamma" else L
    if geo is None:
        geo = tr.rns_geometry(R, lout, N, vec, share_rows=kind.startswith("plain"))
    else:
        geo = dict(geo, vec=vec, tiles=-(-(N // vec) // geo["threads"]))
        geo["grid_z"] = min(geo["grid_z"], lout)
    _covers_once(geo, R, lout, N)
    k = [int(v) for v in to_numpy(consts)]
    got, writes = _emulate(kind, geo, R, L, N, x, k, aux=aux, m=m)
    assert (writes == 1).all()
    xt = to_tensor(x, "cpu")
    if kind in ("sm_mrq", "sk_tail"):
        want = tr.behz_plain(kind, xt, consts,
                             aux=None if aux is None else to_tensor(aux, "cpu"))
    else:
        want = tr.scale_round_plain(kind, xt, consts,
                                    plain=None if m is None else to_tensor(m, "cpu"))
    want = to_numpy(want).reshape(got.shape)
    assert (got.astype(np.uint64) == want).all()
