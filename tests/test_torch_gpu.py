"""Card tests: each hand-written kernel against its plain PyTorch version on
the same inputs on the card, bit for bit (the BFV slice's at config 3's
ring, with the 60-bit Bsk primes and m_tilde = 2^32; the NTT's large-ring
mode at N=32768 and 65536; the Galois kernel's signed and paired modes and
the contraction's broadcast mode), and the fused step, the train step, the
hoisted rotations in both key forms, the BFV steps and rotations and the
deep polynomial against the plain path, and keygen, encryption and
decryption at N=32768.  They need a CUDA card and skip without one; on a machine with
an H100 run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the root conftest.py imports jax, which the port does
not need.)
"""

import numpy as np
import pytest
import torch

import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch.models.pipelines import _tensor_product
from gemini_seal_tpu_torch.ops import cuda
from gemini_seal_tpu_torch.ops import ntt as tn
from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor
from gemini_seal_tpu_torch.ops.galois import GaloisTool, galois_permute
from gemini_seal_tpu_torch.ops.dyadic import LimbConstants
from gemini_seal_tpu_torch.ops.modops import contract_mulmod_128, rns_elementwise
from gemini_seal_tpu_torch.utils.numth import get_primes

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mods(n, bits=(60, 50, 40)):
    return [get_primes(n, b, 1)[0] for b in bits]


def _res(rng, mods, lead, n, mult=1):
    x = np.stack([rng.integers(0, mult * p, size=lead + (n,), dtype=np.uint64)
                  for p in mods], axis=len(lead))
    return x


def _both(fn, *args, **kwargs):
    before = cuda.LAUNCHES.copy()
    got = fn(*args, **kwargs)
    launched = {k: cuda.LAUNCHES[k] - before[k] for k in before}
    with plain_versions():
        want = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert sum(launched.values()) >= 1
    return got, want


@pytest.mark.parametrize("log_n", [10, 13, 14])
@pytest.mark.parametrize("name,mult", [("ntt_forward_lazy", 4), ("ntt_forward", 4),
                                       ("ntt_inverse_lazy", 2), ("ntt_inverse", 2)])
def test_ntt_kernel(card, log_n, name, mult):
    n = 1 << log_n
    mods = _mods(n)
    tables = tn.build_ntt_tables(log_n, mods).to(card)
    x = to_tensor(_res(np.random.default_rng(log_n), mods, (4,), n, mult), card)
    got, want = _both(getattr(tn, name), x, tables)
    assert torch.equal(got, want)


def test_ntt_kernel_rejects_what_it_cannot_take(card):
    import dataclasses

    # above SEAL's cap of 65536 (tables relabelled: the check comes first)
    small = tn.build_ntt_tables(10, _mods(1024, (50,))).to(card)
    tables = dataclasses.replace(small, coeff_count=1 << 17, coeff_count_power=17)
    with pytest.raises(ValueError, match="outside"):
        tn.ntt_forward(torch.zeros((1, 1 << 17), dtype=torch.int64, device=card), tables)
    tables = tn.build_ntt_tables(10, _mods(1024)).to(card)
    x = torch.zeros((3, 2048), dtype=torch.int64, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tn.ntt_forward(x, tables)


_LARGE_TABLES = {}


@pytest.mark.parametrize("log_n", [15, 16])
@pytest.mark.parametrize("name,mult", [("ntt_forward_lazy", 4), ("ntt_forward", 4),
                                       ("ntt_inverse_lazy", 2), ("ntt_inverse", 2)])
def test_ntt_kernel_large_ring(card, log_n, name, mult):
    """The large-ring mode (N = 32768, 65536): global-memory stages, then
    16384-coefficient sub-rows, with a 60-bit, a 59-bit and a 40-bit prime,
    inputs over the whole lazy range."""
    n = 1 << log_n
    if log_n not in _LARGE_TABLES:
        mods = _mods(n, (60, 59, 40))
        _LARGE_TABLES[log_n] = (mods, tn.build_ntt_tables(log_n, mods).to(card))
    mods, tables = _LARGE_TABLES[log_n]
    x = _res(np.random.default_rng(log_n), mods, (2,), n, mult)
    x[0, :, -1] = [mult * p - 1 for p in mods]
    before = cuda.LAUNCHES["ntt:large_ring"]
    got, want = _both(getattr(tn, name), to_tensor(x, card), tables)
    assert cuda.LAUNCHES["ntt:large_ring"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("square", [False, True])
def test_tensor_product_kernel(card, square):
    n = 8192
    mods = _mods(n, (50, 40, 40))
    limbs = LimbConstants.from_moduli(mods, card)
    rng = np.random.default_rng(1)
    a = to_tensor(np.stack([_res(rng, mods, (5,), n)] * 2, axis=1), card)
    b = None if square else to_tensor(np.stack([_res(rng, mods, (5,), n)] * 2, axis=1), card)
    got, want = _both(_tensor_product, a, b, limbs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("form", ["modup", "key", "dot"])
def test_contract_kernel(card, form):
    n = 2048
    rng = np.random.default_rng(2)
    ext = _mods(n, (50, 40, 40, 60))
    J = len(ext)
    p = to_tensor(np.array(ext, dtype=np.uint64), card)
    from gemini_seal_tpu_torch.modulus import Modulus
    r0 = to_tensor(np.array([Modulus(q).const_ratio[0] for q in ext], dtype=np.uint64), card)
    r1 = to_tensor(np.array([Modulus(q).const_ratio[1] for q in ext], dtype=np.uint64), card)
    prescale = None
    if form == "modup":      # [B, G=3, K=2, 1, N] x [3, 2, J, 1] with a pre-scale
        a = to_tensor(rng.integers(0, 1 << 50, size=(4, 3, 2, 1, n), dtype=np.uint64), card)
        w = to_tensor(rng.integers(0, 1 << 40, size=(3, 2, J, 1), dtype=np.uint64), card)
        qs = [ext[i % 3] for i in range(6)]
        prescale = tuple(to_tensor(np.array(v, dtype=np.uint64).reshape(3, 2), card) for v in (
            rng.integers(0, 1 << 30, size=6), qs,
            [Modulus(q).const_ratio[0] for q in qs], [Modulus(q).const_ratio[1] for q in qs]))
    elif form == "key":      # [B, 1, K=3, J, N] x [1, 3, J, N]
        a = to_tensor(rng.integers(0, 1 << 52, size=(4, 1, 3, J, n), dtype=np.uint64), card)
        w = to_tensor(rng.integers(0, 1 << 40, size=(1, 3, J, n), dtype=np.uint64), card)
    else:                    # [B, 1, K=2, 1, N] x [1, 2, J, 1]
        a = to_tensor(rng.integers(0, 1 << 60, size=(4, 1, 2, 1, n), dtype=np.uint64), card)
        w = to_tensor(rng.integers(0, 1 << 60, size=(1, 2, J, 1), dtype=np.uint64), card)
    got, want = _both(contract_mulmod_128, a, w, p, r0, r1, prescale=prescale)
    assert torch.equal(got, want)


def test_contract_kernel_broadcast(card):
    """One input broadcast over the groups (the shared-digit contraction:
    digits [B, 1, nb, n_ext, N] against R keys [R, nb, n_ext, N])."""
    from gemini_seal_tpu_torch.modulus import Modulus

    n = 2048
    rng = np.random.default_rng(4)
    ext = _mods(n, (50, 40, 40, 60))
    J = len(ext)
    p = to_tensor(np.array(ext, dtype=np.uint64), card)
    r0 = to_tensor(np.array([Modulus(q).const_ratio[0] for q in ext], dtype=np.uint64), card)
    r1 = to_tensor(np.array([Modulus(q).const_ratio[1] for q in ext], dtype=np.uint64), card)
    a = to_tensor(rng.integers(0, 1 << 60, size=(3, 1, 3, J, n), dtype=np.uint64), card)
    w = to_tensor(rng.integers(0, 1 << 60, size=(5, 3, J, n), dtype=np.uint64), card)
    before = cuda.LAUNCHES["contract:broadcast"]
    got, want = _both(contract_mulmod_128, a, w, p, r0, r1)
    assert cuda.LAUNCHES["contract:broadcast"] == before + 1
    assert got.shape == (3, 5, J, n) and torch.equal(got, want)
    copied = contract_mulmod_128(a.expand(3, 5, 3, J, n).contiguous(), w, p, r0, r1)
    assert torch.equal(got, copied)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "muladd", "addmul", "barrett64"])
@pytest.mark.parametrize("b_kind", ["full", "broadcast", "limb"])
def test_elementwise_kernel(card, op, b_kind):
    n = 4096
    mods = _mods(n)
    limbs = LimbConstants.from_moduli(mods, card)
    rng = np.random.default_rng(3)
    a = to_tensor(_res(rng, mods, (3,), n), card)
    b = {"full": to_tensor(_res(rng, mods, (3,), n), card),
         "broadcast": to_tensor(_res(rng, mods, (), n), card),
         "limb": to_tensor(np.array([[7], [11], [13]], dtype=np.uint64), card)}[b_kind]
    s = to_tensor(np.array([[3], [5], [2**39 + 1]], dtype=np.uint64), card)
    got, want = _both(rns_elementwise, op, a, limbs.p, limbs.ratio0, limbs.ratio1,
                      b=None if op == "neg" else b, s=s)
    assert torch.equal(got, want)


@pytest.mark.parametrize("square", [False, True])
def test_fused_step_matches_plain_path(card, square):
    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    encoder = T.CKKSEncoder(ctx)
    vals = [0.5, -1.25, 3.0]
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(encoder.encode(vals, 2.0 ** 40))
    rk = kg.relin_keys().stacked(2)
    a = torch.stack([ct.data] * 3)
    fn = T.build_ckks_mul_relin_rescale(ctx, fused=True, square=square)
    got, want = _both(fn, *((a, rk) if square else (a, a, rk)))
    assert torch.equal(got, want)
    cd = ctx.first_context_data()
    scale = 2.0 ** 80 / cd.parms.coeff_modulus[-1].value
    out = T.Decryptor(ctx, kg.secret_key).decrypt(
        T.Ciphertext(got[2], cd.next_context_data.parms_id, True, scale))
    for g, v in zip(encoder.decode(out), vals):
        assert abs(g - v * v) < 1e-4


@pytest.mark.parametrize("log_n", [10, 13])
@pytest.mark.parametrize("R", [1, 8])
def test_galois_kernel(card, log_n, R):
    n = 1 << log_n
    tool = GaloisTool(log_n, card)
    tabs = tool.ntt_tables(tool.get_elts_from_steps(list(range(1, R + 1))))
    x = to_tensor(_res(np.random.default_rng(log_n + R), _mods(n), (5,), n), card)
    got, want = _both(galois_permute, x, tabs)
    assert got.shape == (5, R, 3, n)
    assert torch.equal(got, want)
    for r in range(R):
        assert torch.equal(got[:, r], x.index_select(-1, tabs[r]))


@pytest.mark.parametrize("log_n", [10, 13, 16])
@pytest.mark.parametrize("mode", ["signed", "paired", "signed_paired"])
def test_galois_kernel_modes(card, log_n, mode):
    """The signed power-basis mode (a zero input at a flipped position stays
    0) and the paired mode, against the plain version."""
    n = 1 << log_n
    tool = GaloisTool(log_n, card)
    elts = tool.get_elts_from_steps([1, 2, 3, -1]) + [2 * n - 1]
    mods = _mods(n)
    moduli = to_tensor(np.array(mods, dtype=np.uint64), card)
    signed, paired = mode != "paired", mode != "signed"
    tabs = tool.coeff_tables(elts) if signed else tool.ntt_tables(elts)
    lead = (2, len(elts), 2) if paired else (2, 2)             # [B, (R,) components]
    x = _res(np.random.default_rng(log_n), mods, lead, n)
    src, neg = tool._coeff_table(elts[0])
    x[..., src[neg][:64]] = 0
    x = to_tensor(x, card)
    if paired:
        x = x.reshape(2, len(elts), 2 * len(mods), n)
    before = dict(cuda.LAUNCHES)
    got, want = _both(galois_permute, x, tabs, moduli if signed else None, paired=paired)
    for m in ("signed", "paired", "signed_paired"):
        assert cuda.LAUNCHES[f"galois:{m}"] - before[f"galois:{m}"] == int(m == mode)
    assert torch.equal(got, want)
    if signed and not paired:
        limbs = LimbConstants.from_moduli(mods, card)
        one = tool.apply_galois(x, elts[0], limbs)
        assert torch.equal(one, got[:, :, 0].reshape(one.shape))


def test_galois_kernel_rejects_what_it_cannot_take(card):
    tool = GaloisTool(10, card)
    tabs = tool.ntt_tables([3])
    x = torch.zeros((3, 2048), dtype=torch.int64, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        galois_permute(x, tabs)
    with pytest.raises(TypeError, match="int64"):
        galois_permute(torch.zeros((3, 1024), dtype=torch.int32, device=card), tabs)
    with pytest.raises(ValueError, match="tabs"):
        galois_permute(torch.zeros((3, 512), dtype=torch.int64, device=card), tabs)
    shifted = torch.cat([tabs.reshape(-1), tabs.reshape(-1)])[1:1025].reshape(1, 1024)
    with pytest.raises(ValueError, match="aligned"):
        galois_permute(torch.zeros((3, 1024), dtype=torch.int64, device=card), shifted)
    moduli = torch.ones(3, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="whole sets"):
        galois_permute(torch.zeros((4, 1024), dtype=torch.int64, device=card), tabs, moduli)
    with pytest.raises(ValueError, match="carry"):
        galois_permute(torch.zeros((2, 3, 1024), dtype=torch.int64, device=card), tabs,
                       paired=True)


def test_train_step_and_rotate_many_match_plain_path(card):
    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    encoder = T.CKKSEncoder(ctx)
    vals = [0.5, -1.25, 3.0, 0.25]
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(encoder.encode(vals, 2.0 ** 40))
    rk = kg.relin_keys().stacked(2)
    steps = [1, 2, 3]
    tool = ctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    a = torch.stack([ct.data] * 2)
    train = T.build_ckks_train_step(ctx)
    got, want = _both(train, a, a, rk, gk.stacked(elts[0]))
    assert torch.equal(got, want)
    rmany = T.build_ckks_rotate_many(ctx, steps)
    got, want = _both(rmany, a, gk.stacked(*elts))
    assert torch.equal(got, want)
    dec = T.Decryptor(ctx, kg.secret_key)
    padded = vals + [0.0] * 4
    for r, s in enumerate(steps):
        out = encoder.decode(dec.decrypt(T.Ciphertext(got[r, 1].contiguous(), ct.parms_id,
                                                      True, ct.scale)))
        for i in range(len(vals)):
            assert abs(out[i] - padded[i + s]) < 1e-4


# --- the BFV slice: K6 behz, K7 scale_round, K4 submul, and K1-K3 at the
# --- 60-bit Bsk primes and m_tilde = 2^32, at config 3's row shapes


@pytest.fixture(scope="module")
def bfv3():
    """BASELINE config 3's ring on the card: N=8192, {50, 40, 40, 40, 50}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 8192
    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 40, 50]))
    parms.set_plain_modulus(T.PlainModulus.batching(n, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device="cuda")
    return ctx, ctx.first_context_data().device_rns_tool


def _bfv_res(rng, moduli, lead, n=8192, mult=1):
    return to_tensor(np.stack([rng.integers(0, mult * p, size=lead + (n,), dtype=np.uint64)
                               for p in moduli], axis=len(lead)), "cuda")


def test_behz_kernel_sm_mrq(bfv3):
    from gemini_seal_tpu_torch.ops.rnsops import sm_mrq

    _, tool = bfv3
    rng = np.random.default_rng(21)
    x = _bfv_res(rng, tool.host.base_Bsk_m_tilde.values(), (4, 2))   # [4, 2, 6, 8192]
    got, want = _both(sm_mrq, x, tool)
    assert got.shape == (4, 2, tool.host.base_Bsk.size, 8192)
    assert torch.equal(got, want)


def test_behz_kernel_sk_tail(bfv3):
    from gemini_seal_tpu_torch.ops.rnsops import fastbconv_sk

    _, tool = bfv3
    rng = np.random.default_rng(22)
    x = _bfv_res(rng, tool.host.base_Bsk.values(), (3, 4))           # [3, 4, 5, 8192]
    got, want = _both(fastbconv_sk, x, tool)
    assert got.shape == (3, 4, tool.host.base_q.size, 8192)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["plain_add", "plain_sub"])
def test_scale_round_kernel_plain(bfv3, mode):
    from gemini_seal_tpu_torch.ops import rnsops

    ctx, _ = bfv3
    cd = ctx.first_context_data()
    t = cd.parms.plain_modulus.value
    rng = np.random.default_rng(23)
    c0 = _bfv_res(rng, [m.value for m in cd.parms.coeff_modulus], (3,))
    m = rng.integers(0, t, size=8192, dtype=np.uint64)
    m[:3] = [0, t - 1, (t + 1) >> 1]
    fn = getattr(rnsops, "multiply_%s_plain_with_scaling_variant" % mode.split("_")[1])
    got, want = _both(fn, c0, to_tensor(m, "cuda"), cd)
    assert torch.equal(got, want)


def test_scale_round_kernel_t_gamma(bfv3):
    from gemini_seal_tpu_torch.ops.rnsops import decrypt_scale_and_round, scale_round

    _, tool = bfv3
    rng = np.random.default_rng(24)
    x = _bfv_res(rng, tool.host.base_q.values(), (4,))
    got, want = _both(decrypt_scale_and_round, x, tool)
    assert got.shape == (4, 8192) and torch.equal(got, want)
    g = tool.host.gamma.value
    tg = np.stack([rng.integers(0, tool.host.t.value, size=(2, 8192), dtype=np.uint64),
                   rng.integers(0, g, size=(2, 8192), dtype=np.uint64)], axis=1)
    neg_g = int(tool.host.neg_inv_q_mod_t_gamma[1])
    tg[0, 1, :2] = [(g >> 1) * pow(neg_g, -1, g) % g, ((g >> 1) + 1) * pow(neg_g, -1, g) % g]
    got, want = _both(scale_round, "t_gamma", to_tensor(tg, "cuda"), tool.t_gamma_consts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b_kind", ["full", "broadcast"])
def test_elementwise_kernel_submul(bfv3, b_kind):
    _, tool = bfv3
    bsk = tool.Bsk_limbs
    mods = tool.host.base_Bsk.values()
    rng = np.random.default_rng(25)
    a = _bfv_res(rng, mods, (3, 4))
    b = _bfv_res(rng, mods, (3, 4) if b_kind == "full" else ())
    got, want = _both(rns_elementwise, "submul", a, bsk.p, bsk.ratio0, bsk.ratio1, b=b,
                      s=tool.inv_prod_q_mod_Bsk)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,mult", [("ntt_forward_lazy", 4), ("ntt_inverse", 2),
                                       ("ntt_inverse_lazy", 2), ("ntt_forward", 4)])
def test_ntt_kernel_bsk_primes(bfv3, name, mult):
    _, tool = bfv3
    x = _bfv_res(np.random.default_rng(26), tool.host.base_Bsk.values(), (3, 2), mult=mult)
    got, want = _both(getattr(tn, name), x, tool.base_Bsk_ntt_tables)
    assert torch.equal(got, want)


@pytest.mark.parametrize("square", [False, True])
def test_tensor_product_kernel_bsk_lazy(bfv3, square):
    _, tool = bfv3
    rng = np.random.default_rng(27)
    mods = tool.host.base_Bsk.values()
    a = torch.stack([_bfv_res(rng, mods, (4,), mult=4)] * 2, dim=1)
    b = None if square else torch.stack([_bfv_res(rng, mods, (4,), mult=4)] * 2, dim=1)
    got, want = _both(_tensor_product, a, b, tool.Bsk_limbs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("conv", ["m_tilde_conv", "q_to_Bsk", "sk_conv", "t_gamma_conv"])
def test_contract_kernel_base_conversions(bfv3, conv):
    """K3 onto the 60-bit Bsk primes and m_tilde = 2^32 (m_tilde_conv), and
    from them (sk_conv)."""
    from gemini_seal_tpu_torch.ops.rnsops import fast_convert_array

    _, tool = bfv3
    c = getattr(tool, conv)
    ibase = [int(p) for p in c.ibase.p.reshape(-1).tolist()]
    x = _bfv_res(np.random.default_rng(28), ibase, (3, 4))
    got, want = _both(fast_convert_array, x, c)
    assert torch.equal(got, want)


def test_divide_and_round_kernels(bfv3):
    from gemini_seal_tpu_torch.ops import rnsops

    ctx, tool = bfv3
    x = _bfv_res(np.random.default_rng(29), tool.host.base_q.values(), (3, 2))
    got, want = _both(rnsops.divide_and_round_q_last, x, tool)
    assert torch.equal(got, want)
    plan = rnsops.MultiDropPlan(ctx, ctx.first_parms_id, 3)
    got, want = _both(rnsops.divide_and_round_multi, x, plan)
    assert got.shape == (3, 2, 1, 8192) and torch.equal(got, want)


@pytest.mark.parametrize("chain", [False, True])
def test_bfv_steps_match_plain_path(card, chain):
    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 40, 50]))
    parms.set_plain_modulus(T.PlainModulus.batching(n, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    be = T.BatchEncoder(ctx)
    t = parms.plain_modulus.value
    v = np.random.default_rng(30).integers(0, t, n)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(be.encode(v.tolist()))
    rk = kg.relin_keys().stacked(2)
    a = torch.stack([ct.data] * 2)
    dec = T.Decryptor(ctx, kg.secret_key)
    if chain:
        forms = [(T.build_bfv_mul_relin_modswitch(ctx, fused_drop=f), ctx.last_parms_id)
                 for f in (True, False)]
    else:
        forms = [(T.build_bfv_mul_relin(ctx), ctx.first_parms_id)]
    for fn, pid in forms:
        got, want = _both(fn, a, a, rk)
        assert torch.equal(got, want)
        out = be.decode(dec.decrypt(T.Ciphertext(got[1], pid, False)))
        assert out == (v.astype(object) ** 2 % t).tolist()
    sq = T.build_bfv_mul_relin(ctx, square=True)
    got, want = _both(sq, a, rk)
    assert torch.equal(got, want)


# --- BFV rotations, counter-rotated keys, the deep polynomial and the large
# --- rings: the steps against the plain path on the card


@pytest.mark.parametrize("prepermuted", [False, True])
def test_rotations_match_plain_path(card, prepermuted):
    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [40] * 5))
    parms.set_plain_modulus(T.PlainModulus.batching(n, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    be = T.BatchEncoder(ctx)
    t = parms.plain_modulus.value
    v = np.random.default_rng(31).integers(0, t, n)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(be.encode(v.tolist()))
    steps = [1, 2, 3]
    tool = ctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps(steps)
    stack = kg.galois_keys(elts).stacked(*elts)
    if prepermuted:
        stack = T.prepermute_galois_stack(tool, elts, stack)
    a = torch.stack([ct.data] * 2)
    got, want = _both(T.build_bfv_rotate_many(ctx, steps, prepermuted_keys=prepermuted),
                      a, stack)
    assert torch.equal(got, want)
    dec = T.Decryptor(ctx, kg.secret_key)
    half = n // 2
    for r, s in enumerate(steps):
        out = be.decode(dec.decrypt(T.Ciphertext(got[r, 1], ct.parms_id, False)))
        assert out == np.concatenate([np.roll(v[:half], -s), np.roll(v[half:], -s)]).tolist()
    # CKKS rotate-many in the same key form
    cparms = T.EncryptionParameters(T.SchemeType.CKKS)
    cparms.set_poly_modulus_degree(n)
    cparms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    cparms.set_random_seed(tuple(range(71, 79)))
    cctx = T.SealContext(cparms, sec_level=T.SecLevelType.none)
    ckg = T.KeyGenerator(cctx)
    cstack = ckg.galois_keys(elts).stacked(*elts)
    if prepermuted:
        cstack = T.prepermute_galois_stack(tool, elts, cstack)
    enc = T.CKKSEncoder(cctx)
    cct = T.Encryptor(cctx, ckg.public_key()).encrypt(enc.encode([0.5, -1.0, 2.0], 2.0 ** 40))
    ca = torch.stack([cct.data] * 2)
    got, want = _both(T.build_ckks_rotate_many(cctx, steps, prepermuted_keys=prepermuted),
                      ca, cstack)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rotate_mode", ["tree", "flat"])
def test_poly_eval_matches_plain_path(card, rotate_mode):
    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [59, 30, 30, 30, 59]))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    enc = T.CKKSEncoder(ctx)
    coeffs = [1.0, -0.5, 0.25, 0.125, 0.0625]
    steps = [1, 2, 3] if rotate_mode == "flat" else [1, 2]
    elts = ctx.first_context_data().galois_tool.get_elts_from_steps(steps)
    gks = kg.galois_keys(elts).stacked(*elts)
    step, deep, scale = T.build_ckks_poly_eval(ctx, coeffs, 2.0 ** 30, enc, rotate_sum_log2=2,
                                               coeff_precision_bits=25,
                                               rotate_mode=rotate_mode)
    v = np.random.default_rng(32).uniform(-1, 1, n // 2)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(enc.encode(v.tolist(), 2.0 ** 30))
    a = torch.stack([ct.data] * 2)
    got, want = _both(step, a, kg.relin_keys().stacked(2), gks)
    assert torch.equal(got, want)
    out = enc.decode(T.Decryptor(ctx, kg.secret_key).decrypt(
        T.Ciphertext(got[1], deep, True, scale)))
    p = lambda x: sum(c * x ** k for k, c in enumerate(coeffs))  # noqa: E731
    assert np.max(np.abs(np.asarray(out) - sum(p(np.roll(v, -j)) for j in range(4)))) < 1e-3


def test_keygen_encrypt_decrypt_n32768(card):
    """Key generation, encryption and decryption at N=32768, every NTT in
    the large-ring mode."""
    n = 32768
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [59, 40, 40, 59]))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    cuda.reset_launches()
    kg = T.KeyGenerator(ctx)
    enc = T.CKKSEncoder(ctx)
    v = np.random.default_rng(33).uniform(-1, 1, n // 2)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(enc.encode(v.tolist(), 2.0 ** 40))
    out = enc.decode(T.Decryptor(ctx, kg.secret_key).decrypt(ct))
    assert cuda.LAUNCHES["ntt:large_ring"] >= 3
    assert np.max(np.abs(np.asarray(out) - v)) < 1e-4
