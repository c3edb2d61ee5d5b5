"""The port's BFV RNS layer (gemini_seal_tpu_torch.utils.rns RNSTool, the BFV
context constants, ops.modops add128/divmod_128 and every function of
ops.rnsops) against the JAX package, exact equality.

The JAX functions run on numpy inputs through the package's host-plane
dispatch (no compile); the port's run through its plain versions on the
CPU.  Ring: N=256, five 40-bit primes (four at the first level, so that a
fused drop removes two or three), t = PlainModulus.batching(256, 20).
Each branch test pins its boundary value: r = m_tilde/2 in sm_mrq,
alpha = m_sk/2 in fastbconv_sk, g = gamma/2 in the {t, gamma} tail, the
carries and the quotient correction of add128/divmod_128, and m = 0,
ceil(t/2) and t-1 in the plain scaling.
"""

import numpy as np
import pytest

import gemini_seal_tpu as J
from gemini_seal_tpu.ops import modops as jm
from gemini_seal_tpu.ops import rnsops as jr
import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.ops import modops as tm
from gemini_seal_tpu_torch.ops import rnsops as tr
from gemini_seal_tpu_torch.ops.backend import to_numpy, to_tensor
from torch_helpers import one_torch_thread  # noqa: F401

N = 256
BITS = [40] * 5
U64_MAX = (1 << 64) - 1


def _context(M, **kw):
    parms = M.EncryptionParameters(M.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(M.CoeffModulus.create(N, BITS))
    parms.set_plain_modulus(M.PlainModulus.batching(N, 20))
    parms.set_random_seed(tuple(range(8)))
    return M.SealContext(parms, sec_level=M.SecLevelType.none, **kw)


@pytest.fixture(scope="module")
def ctxs():
    return _context(J), _context(T, device="cpu")


@pytest.fixture(scope="module")
def tools(ctxs):
    jc, tc = ctxs
    pid = jc.first_parms_id
    return jc.get_context_data(pid).device_rns_tool, tc.get_context_data(pid).device_rns_tool


def _t(a):
    return to_tensor(np.asarray(a, dtype=np.uint64), "cpu")


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want, dtype=np.uint64), to_numpy(got))


def _res(rng, moduli, lead=(2,)):
    return np.stack([rng.integers(0, p, size=lead + (N,), dtype=np.uint64)
                     for p in moduli], axis=len(lead))


def _levels(ctx):
    cd = ctx.key_context_data()
    while cd is not None:
        yield cd
        cd = cd.next_context_data


def test_rns_tool_and_context_constants(ctxs):
    """Every level's host RNSTool and BFV constants, array for array."""
    jc, tc = ctxs
    assert jc.first_parms_id == tc.first_parms_id and jc.last_parms_id == tc.last_parms_id
    for jcd, tcd in zip(_levels(jc), _levels(tc), strict=True):
        assert jcd.parms_id == tcd.parms_id
        for f in ("total_coeff_modulus", "coeff_modulus_mod_plain_modulus",
                  "plain_upper_half_threshold", "upper_half_threshold", "chain_index"):
            assert getattr(jcd, f) == getattr(tcd, f), f
        for f in ("coeff_div_plain_modulus", "upper_half_increment",
                  "plain_upper_half_increment"):
            np.testing.assert_array_equal(getattr(jcd, f), getattr(tcd, f), err_msg=f)
        for f in ("using_fft", "using_ntt", "using_batching", "using_fast_plain_lift",
                  "using_descending_modulus_chain"):
            assert getattr(jcd.qualifiers, f) == getattr(tcd.qualifiers, f), f
        for f in ("root_powers", "scaled_root_powers", "inv_root_powers",
                  "scaled_inv_root_powers", "modulus"):
            _eq(getattr(jcd.plain_ntt_tables, f), getattr(tcd.plain_ntt_tables, f))
        jt, tt = jcd.rns_tool, tcd.rns_tool
        for f in ("m_sk", "gamma", "m_tilde", "t"):
            assert getattr(jt, f).value == getattr(tt, f).value, f
        for f in ("base_q", "base_B", "base_Bsk", "base_Bsk_m_tilde", "base_t_gamma"):
            assert getattr(jt, f).values() == getattr(tt, f).values(), f
        for f in ("base_q_to_Bsk_conv", "base_q_to_m_tilde_conv", "base_B_to_q_conv",
                  "base_B_to_m_sk_conv", "base_q_to_t_gamma_conv"):
            np.testing.assert_array_equal(getattr(jt, f).matrix, getattr(tt, f).matrix)
            np.testing.assert_array_equal(getattr(jt, f).inv_punctured,
                                          getattr(tt, f).inv_punctured)
        for f in ("prod_B_mod_q", "inv_prod_q_mod_Bsk", "inv_m_tilde_mod_Bsk",
                  "prod_q_mod_Bsk", "prod_t_gamma_mod_q", "neg_inv_q_mod_t_gamma",
                  "inv_q_last_mod_q"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
        for f in ("inv_prod_B_mod_m_sk", "inv_prod_q_mod_m_tilde", "inv_gamma_mod_t"):
            assert getattr(jt, f) == getattr(tt, f), f
    jd, td = jc.first_context_data().device_rns_tool, tc.first_context_data().device_rns_tool
    for f in ("root_powers", "inv_root_powers", "modulus"):
        _eq(getattr(jd.base_Bsk_ntt_tables, f), getattr(td.base_Bsk_ntt_tables, f))
    base = jc.first_context_data().rns_base
    vals = [0, 1, base.base_prod - 1, base.base_prod // 3]
    tbase = tc.first_context_data().rns_base
    np.testing.assert_array_equal(base.decompose_array(vals), tbase.decompose_array(vals))
    assert tbase.compose_array(tbase.decompose_array(vals)) == vals
    assert tbase.drop(1).values() == base.drop(1).values()
    assert tbase.drop(1).is_subbase_of(tbase) and not tbase.is_subbase_of(tbase.drop(1))


def test_add128_divmod128_boundaries():
    t = J.PlainModulus.batching(N, 20)
    p, r0, r1 = (np.uint64(v) for v in (t.value, t.const_ratio[0], t.const_ratio[1]))
    rng = np.random.default_rng(5)
    q = rng.integers(0, U64_MAX, size=64, dtype=np.uint64, endpoint=True)
    r = rng.integers(0, int(p), size=64, dtype=np.uint64)
    # x = q * p + r with r at 0, p-1 and random: the correction r >= p
    r[:3] = [0, int(p) - 1, int(p) - 1]
    q[:3] = [U64_MAX, U64_MAX, 0]
    big = [int(a) * int(p) + int(b) for a, b in zip(q, r)]
    hi = np.array([v >> 64 for v in big], dtype=np.uint64)
    lo = np.array([v & U64_MAX for v in big], dtype=np.uint64)
    want = jm.divmod_128(hi, lo, p, r0, r1)
    got = tm.divmod_128(_t(hi), _t(lo), _t(p), _t(r0), _t(r1))
    for w, g in zip(want, got):
        _eq(w, g)
    _eq(q, got[0])
    a_lo = np.array([U64_MAX, U64_MAX, 0, 1 << 63], dtype=np.uint64)
    b_lo = np.array([1, U64_MAX, 0, 1 << 63], dtype=np.uint64)
    a_hi = np.array([0, 7, U64_MAX, 1], dtype=np.uint64)
    want = jm.add128(a_hi, a_lo, a_hi, b_lo)
    got = tm.add128(_t(a_hi), _t(a_lo), _t(a_hi), _t(b_lo))
    for w, g in zip(want, got):
        _eq(w, g)


def test_fast_convert_and_m_tilde_lift(tools):
    jt, tt = tools
    rng = np.random.default_rng(1)
    x = _res(rng, jt.host.base_q.values())
    _eq(jr.fast_convert_array(x, jt.q_to_Bsk), tr.fast_convert_array(_t(x), tt.q_to_Bsk))
    _eq(jr.fastbconv_m_tilde(x, jt), tr.fastbconv_m_tilde(_t(x), tt))


def test_padded_converter_equals_sliced(tools):
    """sk_conv reads the whole Bsk tensor with its x_sk row at weight 0 and
    equals the B -> q and B -> m_sk conversions of the B rows alone."""
    jt, tt = tools
    x = _res(np.random.default_rng(11), jt.host.base_Bsk.values(), (3, 2))
    got = tr.fast_convert_array(_t(x), tt.sk_conv)
    _eq(jr.fast_convert_array(x[..., :-1, :], jt.B_to_q), got[..., :-1, :])
    _eq(jr.fast_convert_array(x[..., :-1, :], jt.B_to_m_sk), got[..., -1:, :])
    with pytest.raises(ValueError, match="begin with"):
        tr.DeviceBaseConverter.from_host(tt.host.base_B_to_q_conv, "cpu",
                                         ibase=tt.host.base_q)


def test_device_rns_tool_behz_part_is_bfv_only():
    """A CKKS level's device tool holds the q-limb rescale constants and
    none of the BEHZ or {t, gamma} part."""
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(T.CoeffModulus.create(N, BITS))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device="cpu")
    tool = ctx.first_context_data().device_rns_tool
    assert tool.q_limbs.p.numel() == len(BITS) - 1
    assert tool.inv_q_last_mod_q.shape == (len(BITS) - 2, 1)
    for attr in ("Bsk_limbs", "base_Bsk_ntt_tables", "m_tilde_conv", "sk_conv",
                 "sm_mrq_consts", "t_gamma_conv"):
        assert not hasattr(tool, attr), attr


def test_sm_mrq_centring_boundary(tools):
    """r = m_tilde/2 takes the centred branch, r = m_tilde/2 - 1 does not."""
    jt, tt = tools
    rng = np.random.default_rng(2)
    x = _res(rng, jt.host.base_Bsk_m_tilde.values())
    inv = pow(int(jt.inv_prod_q_mod_m_tilde), -1, 1 << 32)
    # r = (2^32 - x_mt * inv_q) mod 2^32: x_mt for r = 2^31, 2^31 - 1, 0, 2^32 - 1
    for k, r in enumerate([1 << 31, (1 << 31) - 1, 0, (1 << 32) - 1]):
        x[0, -1, k] = (((1 << 32) - r) % (1 << 32)) * inv % (1 << 32)
    want = jr.sm_mrq(x, jt)
    got = tr.sm_mrq(_t(x), tt)
    _eq(want, got)
    r = ((1 << 32) - (x[0, -1, :2].astype(object) * int(jt.inv_prod_q_mod_m_tilde))
         % (1 << 32)) % (1 << 32)
    assert list(r) == [1 << 31, (1 << 31) - 1]


def test_fast_floor(tools):
    jt, tt = tools
    rng = np.random.default_rng(3)
    x_q = _res(rng, jt.host.base_q.values(), (3, 2))
    x_bsk = _res(rng, jt.host.base_Bsk.values(), (3, 2))
    x_bsk[0, 0, :, :4] = np.array([p - 1 for p in jt.host.base_Bsk.values()],
                                  dtype=np.uint64)[:, None]
    _eq(jr.fast_floor(x_q, x_bsk, jt), tr.fast_floor(_t(x_q), _t(x_bsk), tt))


def test_fastbconv_sk_alpha_boundary(tools):
    """alpha = m_sk/2 takes the positive branch, alpha = m_sk/2 + 1 the
    negative one (alpha > m_sk/2 is the test)."""
    jt, tt = tools
    rng = np.random.default_rng(4)
    x = _res(rng, jt.host.base_Bsk.values(), (3, 2))
    m_sk = jt.m_sk.value
    temp = np.asarray(jr.fast_convert_array(x[..., :-1, :], jt.B_to_m_sk))[..., 0, :]
    prod_b = jt.host.base_B.base_prod % m_sk
    for k, alpha in enumerate([m_sk >> 1, (m_sk >> 1) + 1, 0, m_sk - 1]):
        x[0, 0, -1, k] = (int(temp[0, 0, k]) - alpha * prod_b) % m_sk
    _eq(jr.fastbconv_sk(x, jt), tr.fastbconv_sk(_t(x), tt))


def test_decrypt_scale_and_round(tools, monkeypatch):
    """The whole function on random residues, then its {t, gamma} tail on
    crafted conversions: g = gamma/2 (no correction branch) and gamma/2 + 1."""
    jt, tt = tools
    rng = np.random.default_rng(6)
    x = _res(rng, jt.host.base_q.values(), (3,))
    _eq(jr.decrypt_scale_and_round(x, jt), tr.decrypt_scale_and_round(_t(x), tt))
    g = jt.gamma.value
    neg_g = int(jt.neg_inv_q_mod_t_gamma[1, 0])
    tg = np.stack([rng.integers(0, jt.t.value, size=(3, N), dtype=np.uint64),
                   rng.integers(0, g, size=(3, N), dtype=np.uint64)], axis=1)
    for k, gp in enumerate([g >> 1, (g >> 1) + 1, 0, g - 1]):
        tg[0, 1, k] = gp * pow(neg_g, -1, g) % g
    monkeypatch.setattr(jr, "fast_convert_array", lambda *a: tg)
    _eq(jr.decrypt_scale_and_round(x, jt), tr.scale_round("t_gamma", _t(tg), tt.t_gamma_consts))


@pytest.mark.parametrize("mode", ["add", "sub"])
def test_plain_scaling_variants(ctxs, mode):
    jc, tc = ctxs
    jcd, tcd = jc.first_context_data(), tc.first_context_data()
    t = jcd.parms.plain_modulus.value
    rng = np.random.default_rng(7)
    c0 = _res(rng, [m.value for m in jcd.parms.coeff_modulus], (2,))
    m = rng.integers(0, t, size=N, dtype=np.uint64)
    m[:4] = [0, (t + 1) >> 1, t - 1, t >> 1]
    jf = getattr(jr, f"multiply_{mode}_plain_with_scaling_variant")
    tf = getattr(tr, f"multiply_{mode}_plain_with_scaling_variant")
    _eq(jf(c0, m, jcd), tf(_t(c0), _t(m), tcd))


def test_divide_and_round_q_last(ctxs):
    """Power-basis drop at every level that has two or more primes."""
    jc, tc = ctxs
    rng = np.random.default_rng(8)
    for jcd, tcd in zip(_levels(jc), _levels(tc)):
        moduli = [m.value for m in jcd.parms.coeff_modulus]
        if len(moduli) < 2:
            continue
        x = _res(rng, moduli, (2, 2))
        x[0, 0, -1, :3] = [0, moduli[-1] - 1, moduli[-1] >> 1]
        _eq(jr.divide_and_round_q_last(x, jcd.device_rns_tool),
            tr.divide_and_round_q_last(_t(x), tcd.device_rns_tool))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_divide_and_round_multi(ctxs, levels):
    jc, tc = ctxs
    pid = jc.first_parms_id
    jp, tp = jr.MultiDropPlan(jc, pid, levels), tr.MultiDropPlan(tc, pid, levels)
    assert tp.n_out == jp.n_out == 4 - levels
    moduli = [m.value for m in jc.first_context_data().parms.coeff_modulus]
    x = _res(np.random.default_rng(9 + levels), moduli, (2, 2))
    _eq(jr.divide_and_round_multi(x, jp), tr.divide_and_round_multi(_t(x), tp))
