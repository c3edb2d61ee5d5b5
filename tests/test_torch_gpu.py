"""Card tests: each hand-written kernel against its plain PyTorch version on
the same inputs on the card, bit for bit (the BFV slice's at config 3's
ring, with the 60-bit Bsk primes and m_tilde = 2^32; the NTT at every ring
from N=2 to 65536 with the top of each lazy range planted, its large-ring
mode one launch a transform; the Galois kernel in all four modes at N=16,
8192, 32768 and 65536 with 1, 3 and 8 tables; the contraction in every
form of its callers, its broadcast mode and the edges of its launch
geometry, the top of its lazy range, the key inner product's two
components in one launch), and the fused step, the train step, the
hoisted rotations in both key forms, the BFV steps and rotations and the
deep polynomial against the plain path, keygen, encryption and
decryption at N=32768, the negacyclic monomial multiply (both modes), the
centred norm and the Barrett-64 reduction of ops/dyadic.py, the per-op
Evaluator's ex1 chain at N=4096 against the plain path, K12's passes of
the four-step int8 NTT (ops/ntt_mxu.py) against their plain versions and
K1, and the model zoo's dense layer (both matvec forms), MLP,
multi-channel convolution and BFV matvec at N=1024, and the comparison
builders (sign, max, sqrt), the encrypted matmul (one and four heads) and
encrypted attention (one and two heads) at the CPU tests' rings against
the same builders on the CPU, and K3's pairwise mode at the d=32 matmul's
contraction shape, the wire-to-wire server and Decryptor.decrypt_batch
against the same on the CPU.  They need a CUDA card and skip without one; on a machine with
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


@pytest.mark.parametrize("log_n", range(1, 15))
@pytest.mark.parametrize("name,mult", [("ntt_forward_lazy", 4), ("ntt_forward", 4),
                                       ("ntt_inverse_lazy", 2), ("ntt_inverse", 2)])
def test_ntt_kernel(card, log_n, name, mult):
    """Every one-launch ring, N = 2 .. 16384: stage counts that are and are
    not a multiple of the stages a thread runs in registers, inputs over the
    whole lazy range with its top planted."""
    n = 1 << log_n
    mods = _mods(n)
    tables = tn.build_ntt_tables(log_n, mods).to(card)
    x = _res(np.random.default_rng(log_n), mods, (4,), n, mult)
    x[0, :, 0] = [mult * p - 1 for p in mods]
    x[1, :, -1] = [mult * p - 1 for p in mods]
    x[2, :, n // 2] = [(mult // 2) * p for p in mods]
    got, want = _both(getattr(tn, name), to_tensor(x, card), tables)
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
    x[1, :, 0] = [mult * p - 1 for p in mods]
    x[1, :, n // 2] = [(mult // 2) * p for p in mods]
    before = cuda.LAUNCHES["ntt:large_ring"]
    got, want = _both(getattr(tn, name), to_tensor(x, card), tables)
    assert cuda.LAUNCHES["ntt:large_ring"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("log_n", [15, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_large_ring_is_one_launch(card, log_n, inverse):
    """A large-ring transform is one device kernel (one cluster launch): no
    global-memory stage launch and no scratch buffer are left."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 1 << log_n
    if log_n not in _LARGE_TABLES:
        mods = _mods(n, (60, 59, 40))
        _LARGE_TABLES[log_n] = (mods, tn.build_ntt_tables(log_n, mods).to(card))
    mods, tables = _LARGE_TABLES[log_n]
    x = to_tensor(_res(np.random.default_rng(5), mods, (2,), n), card)
    fn = tn.ntt_inverse if inverse else tn.ntt_forward
    fn(x, tables)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x, tables)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "ntt_kernel" in kernels[0], kernels
    assert not any("ntt_stage" in k for k in kernels)


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


@pytest.mark.parametrize("log_n", [4, 13, 15, 16])
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("mode", ["unsigned", "signed", "paired", "signed_paired"])
def test_galois_kernel_every_mode_and_size(card, log_n, R, mode):
    """All four modes at N = 16, 8192 (one CTA a row), 32768 and 65536 (a
    cluster of 4 and 8 CTAs a row), R = 1, 3, 8 tables, 3 x 3 rows (no
    multiple of a tile), a zero planted where the sign flips."""
    n = 1 << log_n
    tool = GaloisTool(log_n, card)
    elts = tool.get_elts_from_steps(list(range(1, R)) + [-1])
    mods = _mods(n, (60, 50, 40))
    moduli = to_tensor(np.array(mods, dtype=np.uint64), card)
    signed, paired = mode.startswith("signed"), mode.endswith("paired")
    tabs = tool.coeff_tables(elts) if signed else tool.ntt_tables(elts)
    lead = (3, R) if paired else (3,)
    x = _res(np.random.default_rng(log_n * 10 + R), mods, lead, n)
    src, neg = tool._coeff_table(elts[0])
    x[..., src[neg][:8]] = 0
    x = to_tensor(x, card)
    before = dict(cuda.LAUNCHES)
    got, want = _both(galois_permute, x, tabs, moduli if signed else None, paired=paired)
    assert cuda.LAUNCHES["galois"] - before["galois"] == 1
    if mode != "unsigned":
        assert cuda.LAUNCHES[f"galois:{mode}"] - before[f"galois:{mode}"] == 1
    assert got.shape == (3, R, 3, n)
    assert torch.equal(got, want)


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
    unaligned = torch.zeros(3 * 1024 + 1, dtype=torch.int64, device=card)[1:].reshape(3, 1024)
    with pytest.raises(ValueError, match="aligned"):
        galois_permute(unaligned, tabs)
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


# (lead, Ga, G, K, J, Ja, N, Nw, pre-scale): every form of K3's callers and
# its edges: K 1-72, J 1-28, Ja in {1, J}, Nw in {1, N}, Ga in {1, G} up to
# G = 16, one row, N from 2 to 65536 (rows shorter than a tile, N not a
# power of two, odd N: one coefficient a unit)
CONTRACT_CASES = [
    ((1,), 1, 1, 1, 1, 1, 2, 1, False),
    ((3,), 3, 3, 2, 4, 1, 8192, 1, True),          # mod-up
    ((1,), 1, 2, 3, 4, 4, 8192, 8192, False),      # both key components, one row
    ((4,), 1, 2, 3, 4, 4, 4096, 4096, False),      # both key components
    ((2,), 1, 16, 3, 4, 4, 2048, 2048, False),     # shared digits, 16 keys
    ((2,), 16, 16, 2, 3, 3, 1024, 1024, False),    # hoisted keys
    ((1,), 1, 1, 24, 28, 1, 4096, 1, True),        # _dot_mod_128, I = 24, O = 28
    ((2, 2), 1, 1, 28, 24, 1, 512, 1, False),
    ((2,), 1, 1, 8, 28, 28, 1024, 1024, False),    # Ja = J = 28
    ((2,), 2, 2, 7, 3, 3, 65536, 65536, False),
    ((1,), 1, 1, 3, 4, 1, 65536, 1, True),
    ((5,), 1, 3, 2, 4, 1, 16, 1, True),            # one input pre-scaled for each group
    ((3,), 1, 1, 2, 3, 1, 6, 1, False),
    ((2,), 2, 2, 2, 3, 3, 7, 7, False),
    ((1,), 1, 1, 40, 1, 1, 32768, 1, False),
    ((2,), 1, 4, 5, 6, 6, 8, 1, False),            # group M with unit weights, short rows
    ((2,), 2, 2, 3, 4, 4, 256, 256, True),         # a pre-scale with Ja = J
]


def _contract_consts(mods, device):
    from gemini_seal_tpu_torch.modulus import Modulus

    return tuple(to_tensor(np.array(v, dtype=np.uint64), device) for v in (
        mods, [Modulus(q).const_ratio[0] for q in mods], [Modulus(q).const_ratio[1] for q in mods]))


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_contract_kernel_every_form(card, case):
    lead, Ga, G, K, J, Ja, n, Nw, pre = case
    rng = np.random.default_rng(sum(lead) + G * 100 + K * 10 + J + n)
    mods = get_primes(1024, 60, J) if J <= 20 else get_primes(1024, 59, J)
    p, r0, r1 = _contract_consts(mods, card)
    hi = np.array(mods, dtype=np.uint64)
    a = rng.integers(0, 1 << 62, size=lead + (Ga, K, Ja, n), dtype=np.uint64)
    if Ja > 1:
        a %= 4 * hi.reshape(J, 1)       # lazy digits [0, 4p)
    w = rng.integers(0, 1 << 62, size=(G, K, J, Nw), dtype=np.uint64) % hi.reshape(J, 1)
    prescale = None
    if pre:
        qs = get_primes(1024, 50, G * K)
        prescale = (to_tensor(rng.integers(0, 1 << 50, size=(G, K), dtype=np.uint64), card),
                    *(t.reshape(G, K) for t in _contract_consts(qs, card)))
    ta, tw = to_tensor(a, card), to_tensor(w, card)
    before = cuda.LAUNCHES.copy()
    got, want = _both(contract_mulmod_128, ta, tw, p, r0, r1, prescale=prescale)
    assert got.shape == lead + (G, J, n) and torch.equal(got, want)
    assert cuda.LAUNCHES["contract"] - before["contract"] == 1
    broadcast = Ga == 1 and G > 1
    assert cuda.LAUNCHES["contract:broadcast"] - before["contract:broadcast"] == int(broadcast)


def test_contract_kernel_unaligned_input(card):
    """An input that starts 8 bytes past a 16-byte boundary takes one
    coefficient a unit."""
    rng = np.random.default_rng(5)
    mods = get_primes(1024, 50, 3)
    p, r0, r1 = _contract_consts(mods, card)
    flat = to_tensor(rng.integers(0, 1 << 50, size=2 * 4 * 3 * 1024 + 1, dtype=np.uint64), card)
    a = flat[1:].reshape(2, 1, 4, 3, 1024)
    assert a.is_contiguous() and a.data_ptr() % 16 == 8
    w = to_tensor(rng.integers(0, 1 << 50, size=(2, 4, 3, 1024), dtype=np.uint64), card)
    got, want = _both(contract_mulmod_128, a, w, p, r0, r1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lead,G,K,J,n,shoup", [
    ((128,), 3, 1, 4, 8192, True),      # the fused step's mod-up: several waves
    ((1,), 1, 3, 15, 4096, False),      # the refresh's base conversion at batch 1
    ((128,), 4, 2, 2, 4096, True),      # a Shoup call with K > 1 terms
])
def test_contract_kernel_both_prescales(card, lead, G, K, J, n, shoup):
    """The Shoup pre-scale (constants made once per CTA, in calls of several
    waves) and the Barrett mul_mod (smaller calls) each equal the plain
    version, with pre-scale factors s drawn over all 64 bits (most above q)
    and planted at q - 1, q and 2^64 - 1."""
    from gemini_seal_tpu_torch.ops.modops import contract_geometry

    rng = np.random.default_rng(G * 1000 + K * 100 + J)
    mods = get_primes(1024, 59, J)
    p, r0, r1 = _contract_consts(mods, card)
    qs = get_primes(1024, 50, G * K)
    s = rng.integers(0, 1 << 64, size=G * K, dtype=np.uint64, endpoint=False)
    s[:3] = [qs[0] - 1, qs[min(1, G * K - 1)], (1 << 64) - 1]
    prescale = (to_tensor(s.reshape(G, K), card),
                *(t.reshape(G, K) for t in _contract_consts(qs, card)))
    a = to_tensor(rng.integers(0, 1 << 64, size=lead + (G, K, 1, n), dtype=np.uint64), card)
    w = to_tensor(rng.integers(0, 1 << 59, size=(G, K, J, 1), dtype=np.uint64)
                  % np.array(mods, dtype=np.uint64).reshape(J, 1), card)
    geo = contract_geometry(int(np.prod(lead)), G, G, K, J, 1, n, 1, True, 2)
    assert geo["shoup"] == int(shoup)
    got, want = _both(contract_mulmod_128, a, w, p, r0, r1, prescale=prescale)
    assert torch.equal(got, want)


def test_contract_kernel_top_of_lazy_range(card):
    """Inputs at 4p - 1 and weights at p - 1 at the largest K that
    KeySwitchPlan.lazy_digits admits for the larger of two 60-bit primes,
    each output limb at both ends of its row."""
    mods = get_primes(1024, 60, 2)
    K = ((1 << 128) - 1) // (4 * max(mods) ** 2)
    p, r0, r1 = _contract_consts(mods, card)
    hi = np.array(mods, dtype=np.uint64).reshape(2, 1)
    for n, Ja in ((4096, 2), (2, 1)):
        a = np.broadcast_to(4 * hi[:Ja] - 1, (3, 1, K, Ja, n)).copy()
        w = np.broadcast_to(hi - 1, (2, K, 2, n)).copy()
        got, want = _both(contract_mulmod_128, to_tensor(a, card), to_tensor(w, card), p, r0, r1)
        assert torch.equal(got, want)
        for j, q in enumerate(mods):
            x = 4 * (mods[j] if Ja > 1 else mods[0]) - 1
            assert int(got[0, 0, j, 0]) == K * x * (q - 1) % q


def test_contract_kernel_m_tilde_modulus(card):
    """The 2^32 output modulus of fastbconv_m_tilde (r0 = 0, r1 = 2^32)."""
    rng = np.random.default_rng(9)
    ib = get_primes(1024, 50, 5)
    p = to_tensor(np.array([1 << 32], dtype=np.uint64), card)
    r0 = to_tensor(np.array([0], dtype=np.uint64), card)
    r1 = to_tensor(np.array([1 << 32], dtype=np.uint64), card)
    a = to_tensor(rng.integers(0, min(ib), size=(8, 1, 5, 1, 8192), dtype=np.uint64), card)
    w = to_tensor(rng.integers(0, 1 << 32, size=(1, 5, 1, 1), dtype=np.uint64), card)
    qs = _contract_consts(ib, card)
    pre = (to_tensor(rng.integers(0, min(ib), size=(1, 5), dtype=np.uint64), card),
           *(t.reshape(1, 5) for t in qs))
    got, want = _both(contract_mulmod_128, a, w, p, r0, r1, prescale=pre)
    assert torch.equal(got, want)


def test_contract_kernel_key_pair_is_one_launch(card):
    """The key inner product's two components as one broadcast launch equal
    two single-component calls; keyswitch_inner_product makes that one
    launch (and the fused step four contract launches in all)."""
    from gemini_seal_tpu_torch.ops.keyswitch import (KeySwitchPlan, compute_modup_digits,
                                                     keyswitch_inner_product)

    n = 8192
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    rk = kg.relin_keys().stacked(2)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    rng = np.random.default_rng(12)
    mods = [m.value for m in ctx.first_context_data().parms.coeff_modulus]
    target = _res(rng, mods[:plan.n_ct_rns], (4,), n)
    digits = compute_modup_digits(to_tensor(target, card), plan, True)
    ext = plan.ext_limbs
    nb = digits.shape[-3]
    key2 = rk[:nb].transpose(0, 1).index_select(-2, plan.ext_key_indices)
    a = digits.reshape(4, 1, nb, plan.n_ext, n)
    consts = (ext.p.reshape(-1), ext.ratio0.reshape(-1), ext.ratio1.reshape(-1))
    before = cuda.LAUNCHES.copy()
    both = contract_mulmod_128(a, key2, *consts)
    assert cuda.LAUNCHES["contract"] - before["contract"] == 1
    assert cuda.LAUNCHES["contract:broadcast"] - before["contract:broadcast"] == 1
    for l in range(2):
        one = contract_mulmod_128(a, key2[l:l + 1].contiguous(), *consts)
        assert torch.equal(both[:, l], one[:, 0])
    assert cuda.LAUNCHES["contract:broadcast"] - before["contract:broadcast"] == 1
    before = cuda.LAUNCHES.copy()
    raw = keyswitch_inner_product(digits, rk, plan, True, raw=True)
    assert cuda.LAUNCHES["contract"] - before["contract"] == 1
    with plain_versions():
        want = keyswitch_inner_product(digits, rk, plan, True, raw=True)
    for g, w in zip(raw, want):
        assert torch.equal(g, w)
    assert torch.equal(raw[0], both[:, 0]) and torch.equal(raw[1], both[:, 1])
    x = to_tensor(np.stack([target] * 2, 1), card)     # [4, 2, n_ct, N]
    before = cuda.LAUNCHES.copy()
    T.build_ckks_mul_relin_rescale(ctx, fused=True)(x, x, rk)
    assert cuda.LAUNCHES["contract"] - before["contract"] == 4


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


def _rows_of(tool, name):
    return [int(v) for v in getattr(tool.host, name).values()]


@pytest.mark.parametrize("lead,n,vec,shoup", [
    ((128, 2), 8192, 2, 1),   # the BFV chain's step: two coefficients a unit, Shoup
    ((4, 2), 8192, 1, 1),
    ((1,), 4096, 1, 0),       # a one-row call: limbs over the grid, Barrett
    ((3,), 4160, 1, 0),
    ((2,), 4097, 1, 0),
    ((70000,), 4, 1, 1),
])
def test_behz_kernel_sm_mrq_centring_and_geometry(bfv3, lead, n, vec, shoup):
    """r at m_tilde/2 - 1, m_tilde/2 and m_tilde/2 + 1 (and 0, m_tilde - 1)
    planted in the first row, in each form that rns_geometry picks: the
    main path's shape, a smaller one, a one-row call, a coefficient count
    that is not a multiple of the tile, an odd one (one coefficient a unit)
    and more rows than the grid's y axis takes."""
    from gemini_seal_tpu_torch.ops.rnsops import rns_geometry, sm_mrq

    _, tool = bfv3
    geo = rns_geometry(int(np.prod(lead)), tool.host.base_Bsk.size, n, 2 if n % 2 == 0 else 1)
    assert (geo["vec"], geo["shoup"]) == (vec, shoup)
    x = _res(np.random.default_rng(31), _rows_of(tool, "base_Bsk_m_tilde"), lead, n)
    inv = pow(int(tool.host.inv_prod_q_mod_m_tilde), -1, 1 << 32)
    plants = [(1 << 31) - 1, 1 << 31, (1 << 31) + 1, 0, (1 << 32) - 1]
    first = (0,) * len(lead)
    for c, r in enumerate(plants[:n]):
        x[first + (-1, c)] = (-r % (1 << 32)) * inv % (1 << 32)
    got, want = _both(sm_mrq, to_tensor(x, "cuda"), tool)
    assert got.shape == lead + (tool.host.base_Bsk.size, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lead,n,vec,shoup", [
    ((3, 128), 8192, 2, 1),   # the BFV chain's step: two coefficients a unit, Shoup
    ((3, 4), 8192, 1, 1),
    ((1,), 4096, 1, 0),       # a one-row call: limbs over the grid, Barrett
    ((3,), 4160, 1, 0),
    ((2,), 4097, 1, 0),
])
def test_behz_kernel_sk_tail_branches_and_geometry(bfv3, lead, n, vec, shoup):
    """alpha at m_sk/2 (the positive branch) and m_sk/2 + 1 (the negative
    one), each with x_sk at 0 and at m_sk - 1, planted in the first row's
    first four coefficients, in each form that rns_geometry picks."""
    from gemini_seal_tpu_torch.ops.rnsops import behz, rns_geometry

    _, tool = bfv3
    geo = rns_geometry(int(np.prod(lead)), tool.host.base_q.size, n, 2 if n % 2 == 0 else 1)
    assert (geo["vec"], geo["shoup"]) == (vec, shoup)
    rng = np.random.default_rng(32)
    m_sk = tool.host.m_sk.value
    conv = _res(rng, _rows_of(tool, "base_q") + [m_sk], lead, n)
    x_bsk = _res(rng, _rows_of(tool, "base_Bsk"), lead, n)
    prod_b = pow(int(tool.host.inv_prod_B_mod_m_sk), -1, m_sk)
    first = (0,) * len(lead)
    for c, (alpha, x_sk) in enumerate([(m_sk >> 1, 0), (m_sk >> 1, m_sk - 1),
                                       ((m_sk >> 1) + 1, 0), ((m_sk >> 1) + 1, m_sk - 1)]):
        x_bsk[first + (-1, c)] = x_sk
        conv[first + (-1, c)] = (alpha * prod_b + x_sk) % m_sk
    got, want = _both(behz, "sk_tail", to_tensor(conv, "cuda"), tool.sk_tail_consts,
                      aux=to_tensor(x_bsk, "cuda"))
    assert got.shape == lead + (tool.host.base_q.size, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [4096, 8192, 4160, 4097])
@pytest.mark.parametrize("R", [1, 3, 128])
@pytest.mark.parametrize("mode", ["plain_add", "plain_sub", "t_gamma"])
def test_scale_round_kernel_rows_and_sizes(bfv3, mode, R, n):
    """K7 in every mode at R = 1, 3 and 128 rows (plain modes: rows shared
    by a thread beside rows over the grid), N = 4096 and 8192, a coefficient
    count that is not a multiple of the tile and an odd one; m at 0, t - 1
    and ceil(t/2), the gamma-centring boundary planted (t_gamma)."""
    from gemini_seal_tpu_torch.ops.rnsops import scale_round

    ctx, tool = bfv3
    cd = ctx.first_context_data()
    rng = np.random.default_rng(33 + R)
    t = cd.parms.plain_modulus.value
    if mode == "t_gamma":
        g = tool.host.gamma.value
        tg = np.stack([rng.integers(0, t, size=(R, n), dtype=np.uint64),
                       rng.integers(0, g, size=(R, n), dtype=np.uint64)], axis=1)
        inv_neg_g = pow(int(tool.host.neg_inv_q_mod_t_gamma[1]), -1, g)
        tg[0, 1, :2] = [(g >> 1) * inv_neg_g % g, ((g >> 1) + 1) * inv_neg_g % g]
        got, want = _both(scale_round, "t_gamma", to_tensor(tg, "cuda"), tool.t_gamma_consts)
        assert got.shape == (R, n)
    else:
        c0 = _res(rng, [m.value for m in cd.parms.coeff_modulus], (R,), n)
        m = rng.integers(0, t, size=n, dtype=np.uint64)
        m[:3] = [0, t - 1, (t + 1) >> 1]
        got, want = _both(scale_round, mode, to_tensor(c0, "cuda"),
                          cd.plain_scaling_constants, plain=to_tensor(m, "cuda"))
    assert torch.equal(got, want)


def test_behz_and_scale_round_unaligned_inputs(bfv3):
    """Inputs 8 bytes off a 16-byte boundary take one coefficient a unit."""
    from gemini_seal_tpu_torch.ops.rnsops import scale_round, sm_mrq

    ctx, tool = bfv3
    rng = np.random.default_rng(34)
    x = to_tensor(_res(rng, _rows_of(tool, "base_Bsk_m_tilde"), (2,), 8192), "cuda")
    off = torch.empty(x.numel() + 1, dtype=torch.int64, device="cuda")
    off[1:] = x.reshape(-1)
    x_off = off[1:].view(x.shape)
    assert x_off.data_ptr() % 16 == 8
    got, want = _both(sm_mrq, x_off, tool)
    assert torch.equal(got, want) and torch.equal(got, sm_mrq(x, tool))
    cd = ctx.first_context_data()
    c0 = to_tensor(_res(rng, [m.value for m in cd.parms.coeff_modulus], (3,), 8192), "cuda")
    off = torch.empty(c0.numel() + 1, dtype=torch.int64, device="cuda")
    off[1:] = c0.reshape(-1)
    m = to_tensor(rng.integers(0, cd.parms.plain_modulus.value, size=8192, dtype=np.uint64),
                  "cuda")
    got, want = _both(scale_round, "plain_add", off[1:].view(c0.shape),
                      cd.plain_scaling_constants, plain=m)
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


@pytest.mark.parametrize("n,L", [(128, 3), (4096, 21), (4096, 24), (4096, 1), (64, 64),
                                 (2, 5), (1024, 64)])
def test_mod_raise_kernel(card, n, L):
    """K8 against its plain version, one launch a call: random residues mod
    q0 and the boundary residues 0, q0/2 - 1, q0/2, q0/2 + 1 and q0 - 1, at
    the bootstrap's row shapes ([2, 1, N] with no batch axis, a batch of 3,
    and 70,000 rows of N = 2, more than the grid's y axis), L from 1 to the
    64 primes a launch takes (limb groups that do and do not divide L), and
    an input at an 8-byte offset into its storage."""
    from gemini_seal_tpu_torch.modulus import Modulus
    from gemini_seal_tpu_torch.ops.modraise import mod_raise_lift

    mods = [Modulus(p) for p in get_primes(n, 59, 1) + (get_primes(n, 45, L - 1) if L > 1
                                                         else [])]
    q0 = mods[0].value
    p, r1, qm = (to_tensor([f(m) for m in mods], card)
                 for f in (lambda m: m.value, lambda m: m.const_ratio[1], lambda m: q0 % m.value))
    rng = np.random.default_rng(n + L)
    pins = [0, (q0 >> 1) - 1, q0 >> 1, (q0 >> 1) + 1, q0 - 1]
    for lead in ((2,), (3, 2)) + (((70000,),) if n == 2 else ()):
        c = rng.integers(0, q0, size=lead + (1, n), dtype=np.uint64)
        flat = c.reshape(-1)
        m = min(5, flat.size)
        flat[:m] = pins[:m]
        flat[-m:] = pins[::-1][:m]
        x = to_tensor(c, card)
        before = cuda.LAUNCHES["mod_raise"]
        got, want = _both(mod_raise_lift, x, p, r1, qm, q0 >> 1)
        assert cuda.LAUNCHES["mod_raise"] == before + 1
        assert got.shape == lead + (L, n) and torch.equal(got, want)
        # row 0 is q0 itself: every residue comes back unchanged
        assert torch.equal(got[..., 0, :], x[..., 0, :])
    # an input 8 bytes into its storage
    xs = to_tensor(np.concatenate([[7], c.reshape(-1)[:2 * n]]).astype(np.uint64), card)
    x1 = xs[1:].reshape(2, 1, n)
    assert x1.data_ptr() % 16 == 8
    got, want = _both(mod_raise_lift, x1, p, r1, qm, q0 >> 1)
    assert torch.equal(got, want)


def test_mod_raise_kernel_refuses_more_primes_than_a_launch_takes(card):
    from gemini_seal_tpu_torch.modulus import Modulus
    from gemini_seal_tpu_torch.ops.modraise import mod_raise_lift

    mods = [Modulus(p) for p in get_primes(64, 50, 65)]
    p, r1, qm = (to_tensor([f(m) for m in mods], card)
                 for f in (lambda m: m.value, lambda m: m.const_ratio[1],
                           lambda m: mods[0].value % m.value))
    x = torch.zeros((2, 1, 64), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="exceed the 64"):
        mod_raise_lift(x, p, r1, qm, mods[0].value >> 1)


@pytest.fixture(scope="module")
def ckks8192():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 8192
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    enc = T.CKKSEncoder(ctx)
    v = np.random.default_rng(34).uniform(-1, 1, n // 2)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(enc.encode(v.tolist(), 2.0 ** 40))
    return ctx, kg, enc, v, torch.stack([ct.data] * 2)


@pytest.mark.parametrize("form", ["fused", "unfused", "bsgs", "bsgs_baby3"])
def test_matvec_matches_plain_path(ckks8192, form):
    ctx, kg, enc, v, a = ckks8192
    slots = v.size
    M = np.random.default_rng(1).uniform(-0.5, 0.5, size=(8, 8))
    diags = {d: [M[i % 8, (i + d) % 8] for i in range(slots)] for d in range(8)}
    tool = ctx.first_context_data().galois_tool
    if form.startswith("bsgs"):
        step, steps = T.build_ckks_matvec_bsgs(ctx, diags, 2.0 ** 40, enc,
                                               baby=3 if form == "bsgs_baby3" else None)
    else:
        step, steps = T.build_ckks_matvec(ctx, diags, 2.0 ** 40, enc,
                                          fuse_moddown=form == "fused"), list(range(1, 8))
    elts = tool.get_elts_from_steps(steps)
    got, want = _both(step, a, kg.galois_keys(elts).stacked(*elts))
    assert torch.equal(got, want)
    out = enc.decode(T.Decryptor(ctx, kg.secret_key).decrypt(
        T.Ciphertext(got[1].contiguous(), ctx.first_parms_id, True, 2.0 ** 80)))
    want_mx = sum(np.asarray(vec) * np.roll(v, -d) for d, vec in diags.items())
    assert np.max(np.abs(np.asarray(out) - want_mx)) < 1e-4


def test_bootstrap_matches_plain_path(card):
    """A whole refresh at N=1024 with two special primes (19 ciphertext
    primes at the top: bundles of two and a short last one), radix 4:
    kernels against the plain path bit for bit, and the decode within the
    JAX test's 5e-6 (tests/test_bootstrap.py:293-303)."""
    from gemini_seal_tpu_torch.evaluator import Evaluator
    from gemini_seal_tpu_torch.models.bootstrap import build_ckks_bootstrap, plan_bootstrap_chain

    n = 1024
    bits, _, _ = plan_bootstrap_chain(n, radix=4, nsp=2, restored=1)
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, bits))
    parms.set_n_special_primes(2)
    parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    assert len(ctx.first_context_data().parms.coeff_modulus) == 19
    kg = T.KeyGenerator(ctx)
    enc = T.CKKSEncoder(ctx)
    fn, pid, scale, steps, conj = build_ckks_bootstrap(ctx, 2.0 ** 45, enc,
                                                       linear_mode="split", radix=4)
    elts = ctx.first_context_data().galois_tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts + [conj])
    rng = np.random.default_rng(13)
    msg = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = T.Encryptor(ctx, kg.public_key()).encrypt(enc.encode(msg.tolist(), 2.0 ** 45))
    ev = Evaluator(ctx)
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    cuda.reset_launches()
    got, want = _both(fn, ct.data, gk.stacked(*elts), gk.stacked(conj),
                      kg.relin_keys().stacked(2))
    assert torch.equal(got, want) and cuda.LAUNCHES["mod_raise"] == 1
    out = np.asarray(enc.decode(T.Decryptor(ctx, kg.secret_key).decrypt(
        T.Ciphertext(got, pid, True, scale)), as_complex=True))
    assert np.abs(out - msg).max() < 5e-6


@pytest.mark.parametrize("n", [2, 64, 4096, 32768, 65536, 131072])
@pytest.mark.parametrize("mode", ["shift", "mono_scalar", "mono_per_limb"])
def test_negacyclic_kernel(card, n, mode):
    """K9 in both modes on random residues with zeros planted, at the shifts
    that wrap nothing, all or all but one coefficient, and beyond N, N = 2
    to 2^17; the monomial's coefficient in [p, 2p) (the fast plain lift's
    q_i - t + c), up to 2p - 1."""
    from gemini_seal_tpu_torch.ops import dyadic

    mods = _mods(n, (60, 50, 40))
    limbs = LimbConstants.from_moduli(mods, card)
    x = _res(np.random.default_rng(n), mods, (2,), n)
    x[..., ::5] = 0
    a = to_tensor(x, card)
    col = to_tensor(np.array([2 * p - 1 - i for i, p in enumerate(mods)],
                             dtype=np.uint64).reshape(-1, 1), card)
    for k in (1, 3, n - 1, n, n + 1, 2 * n - 1, 0):
        before = cuda.LAUNCHES.copy()
        if mode == "shift":
            if k == 0:
                continue  # x^0 returns its input without a launch
            got, want = _both(dyadic.negacyclic_shift_poly, a, k, limbs)
        elif mode == "mono_scalar":
            got, want = _both(dyadic.negacyclic_mono_mul_poly, a, max(mods) + 7, k, limbs)
        else:
            got, want = _both(dyadic.negacyclic_mono_mul_poly, a, col, k, limbs)
        label = "negacyclic:" + ("shift" if mode == "shift" else "mono_mul")
        assert cuda.LAUNCHES[label] == before[label] + 1
        assert torch.equal(got, want), (mode, k)


@pytest.mark.parametrize("n,rows", [(2, 3), (64, 5), (4096, 2), (8192, 2), (2, 70000)])
@pytest.mark.parametrize("threads", [32, 64, 256])
def test_negacyclic_kernel_forms(card, monkeypatch, n, rows, threads):
    """Each form of K9 (the shift, the Barrett product by a per-limb tensor,
    the Shoup product by a scalar's host constants) at CTAs of 32, 64 and
    256 threads forced through the host's geometry (one CTA and several a
    row), at every k edge, against the plain version with one launch a call;
    the scalar coefficient at 0, 1, p_0 - 1, p_0 and 2p - 1 of the largest
    prime, the per-limb one at 2p - 1; 70,000 rows of N = 2 on the grid's x
    axis."""
    from gemini_seal_tpu_torch.ops import dyadic

    def forced(N):
        t = min(threads, max(32, 1 << (N - 1).bit_length()))
        return {"threads": t, "log_tiles": (-(-N // t) - 1).bit_length()}
    monkeypatch.setattr(dyadic, "negacyclic_geometry", forced)
    mods = _mods(n, (60, 50, 40))
    limbs = LimbConstants.from_moduli(mods, card)
    x = _res(np.random.default_rng(n + rows), mods, (rows,), n)
    x[..., ::5] = 0
    a = to_tensor(x, card)
    col = to_tensor(np.array([2 * p - 1 for p in mods], dtype=np.uint64).reshape(-1, 1), card)
    scalars = (0, 1, mods[0] - 1, mods[0], 2 * max(mods) - 1)
    for k in sorted({0, 1, n - 1, n, n + 1, 2 * n - 1}):
        calls = [(dyadic.negacyclic_mono_mul_poly, (a, c, k, limbs)) for c in scalars]
        calls.append((dyadic.negacyclic_mono_mul_poly, (a, col, k, limbs)))
        if k:
            calls.append((dyadic.negacyclic_shift_poly, (a, k, limbs)))
        for fn, args in calls:
            before = cuda.LAUNCHES["negacyclic"]
            got, want = _both(fn, *args)
            assert cuda.LAUNCHES["negacyclic"] == before + 1
            assert torch.equal(got, want), (k, fn.__name__)


def test_negacyclic_kernel_refuses_more_limbs_than_a_launch_takes(card):
    from gemini_seal_tpu_torch.ops import dyadic

    mods = get_primes(64, 50, 65)
    limbs = LimbConstants.from_moduli(mods, card)
    a = torch.zeros((1, 65, 64), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="exceed the 64"):
        dyadic.negacyclic_mono_mul_poly(a, 3, 1, limbs)


@pytest.mark.parametrize("n", [64, 4096, 32768])
def test_infty_norm_and_reduce64_kernels(card, n):
    """K10 with magnitudes planted at p>>1 and p>>1 + 1, and K4's reduce64
    on u64 inputs up to 2^63 - 1, each against its plain version."""
    from gemini_seal_tpu_torch.ops import dyadic

    mods = _mods(n, (60, 50, 40))
    limbs = LimbConstants.from_moduli(mods, card)
    rng = np.random.default_rng(n + 1)
    x = _res(rng, mods, (3,), n)
    x[0, :, 7 % n] = [p >> 1 for p in mods]
    x[1, :, 9 % n] = [(p >> 1) + 1 for p in mods]
    got, want = _both(dyadic.poly_infty_norm, to_tensor(x, card), limbs)
    assert got.shape == (3, 3) and torch.equal(got, want)
    wide = rng.integers(0, 1 << 63, size=(3, 3, n), dtype=np.uint64)
    wide[0, :, 0] = (1 << 63) - 1
    before = cuda.LAUNCHES["elementwise:reduce64"]
    got, want = _both(dyadic.modulo_poly_coeffs, to_tensor(wide, card), limbs)
    assert cuda.LAUNCHES["elementwise:reduce64"] == before + 1
    assert torch.equal(got, want)


def test_per_op_chain_matches_plain_path(card):
    """examples/ex1_bfv_basics.py at N=4096 through the Evaluator on the card
    against the same chain with every kernel's plain version, then the
    decrypt and the noise budget."""
    parms = T.EncryptionParameters(T.SchemeType.BFV)
    parms.set_poly_modulus_degree(4096)
    parms.set_coeff_modulus(T.CoeffModulus.bfv_default(4096))
    parms.set_plain_modulus(1024)
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, device=card)
    kg = T.KeyGenerator(ctx, device=card)
    rk = kg.relin_keys()
    ev = T.Evaluator(ctx, device=card)
    dec = T.Decryptor(ctx, kg.secret_key, device=card)
    x = T.Encryptor(ctx, kg.public_key(), device=card).encrypt(
        T.Plaintext.from_hex("6", device=card))

    def chain():
        P = lambda h: T.Plaintext.from_hex(h, device=card)  # noqa: E731
        a = ev.add_plain(ev.relinearize(ev.square(x), rk), P("1"))
        b = ev.relinearize(ev.square(ev.add_plain(x, P("1"))), rk)
        r = ev.relinearize(ev.multiply(ev.multiply_plain(a, P("4")), b), rk)
        return [a.data, b.data, r.data]

    before = cuda.LAUNCHES["negacyclic:mono_mul"]
    got = chain()
    assert cuda.LAUNCHES["negacyclic:mono_mul"] == before + 1
    with plain_versions():
        want = chain()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    r = T.Ciphertext(got[2], x.parms_id, False)
    assert int(dec.decrypt(r).data[0].item()) == 84
    assert dec.invariant_noise_budget(r) == 10


# --------------------------------------------------------------------------
# the multi-device schedules: K11 ntt_sp, K1 sub_row, the schedules on four
# threads of the card, and the NCCL group on four cards
# --------------------------------------------------------------------------

from gemini_seal_tpu_torch.ops import ntt_sp as tsp  # noqa: E402

_SP_TABLES = {}


def _sp_tables(log_n, card):
    if log_n not in _SP_TABLES:
        n = 1 << log_n
        mods = _mods(n, (60, 50))
        _SP_TABLES[log_n] = (mods, tn.build_ntt_tables(log_n, mods).to(card))
    return _SP_TABLES[log_n]


def _lazy_res(rng, mods, lead, n, mult):
    """Residues over [0, mult p) with the top of the range planted: values
    in [2p, 4p) (forward) or [p, 2p) (inverse) at the lazy-range edges."""
    x = _res(rng, mods, lead, n, mult)
    x[..., :, 0] = [mult * p - 1 for p in mods]
    x[..., :, 1] = [(mult // 2) * p for p in mods]
    return x


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("log_n", [6, 12, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_sp_exchange_kernel(card, C, log_n, inverse):
    """K11 exchange, every rank and every cross stage, against its plain
    version (the last inverse stage folds n^-1 and reduces)."""
    mods, tables = _sp_tables(log_n, card)
    n = 1 << log_n
    rng = np.random.default_rng(C * 100 + log_n)
    mult = 2 if inverse else 4
    log_c = C.bit_length() - 1
    stages = range(log_n - log_c, log_n) if inverse else range(log_c)
    before = cuda.LAUNCHES["ntt_sp:exchange"]
    launches = 0
    for d in range(C):
        own = to_tensor(_lazy_res(rng, mods, (2,), n // C, mult), card)
        partner = to_tensor(_lazy_res(rng, mods, (2,), n // C, mult), card)
        for s in stages:
            got, want = _both(tsp.ntt_sp_exchange, own, partner, tables, d, C, s,
                              inverse=inverse, canonical=True)
            launches += 1
            assert torch.equal(got, want), (d, s)
    assert cuda.LAUNCHES["ntt_sp:exchange"] == before + launches


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("log_n", [6, 12, 16])
@pytest.mark.parametrize("inverse,canonical", [(False, False), (True, False), (True, True)])
def test_ntt_sp_rows_kernel(card, C, log_n, inverse, canonical):
    mods, tables = _sp_tables(log_n, card)
    n = 1 << log_n
    rng = np.random.default_rng(C + log_n)
    y = _lazy_res(rng, mods, (3,), n // C, 2 if inverse else 4)
    y = to_tensor(y.reshape(3, len(mods), C, n // (C * C)), card)
    before = cuda.LAUNCHES["ntt_sp:rows"]
    got, want = _both(tsp.ntt_sp_rows, y, tables, C, inverse=inverse, canonical=canonical)
    assert cuda.LAUNCHES["ntt_sp:rows"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("C,log_n", [(2, 6), (4, 12), (8, 12), (2, 16), (4, 16), (8, 16)])
@pytest.mark.parametrize("inverse,canonical", [(False, False), (False, True), (True, False)])
def test_ntt_sub_row_kernel(card, C, log_n, inverse, canonical):
    """K1 sub_row for every rank index, a chunk of 32768 coefficients at
    N=65536 on two ranks (its stage launches inside the chunk) included."""
    mods, tables = _sp_tables(log_n, card)
    n = 1 << log_n
    rng = np.random.default_rng(C * log_n)
    before = cuda.LAUNCHES["ntt:sub_row"]
    for d in range(C):
        x = to_tensor(_lazy_res(rng, mods, (2,), n // C, 2 if inverse else 4), card)
        got, want = _both(tn.ntt_sub_row, x, tables, d, C, inverse, canonical)
        assert torch.equal(got, want), d
    assert cuda.LAUNCHES["ntt:sub_row"] == before + C


def _four_threads(card, body, *per_rank):
    from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd

    team = ThreadGroup(4, card)
    got = run_spmd(body, team, *per_rank)
    with plain_versions():
        want = run_spmd(body, team, *per_rank)
    torch.cuda.synchronize()
    return got, want


def _split(x, axis):
    b = x.shape[axis] // 4
    return [x.narrow(axis, r * b, b).contiguous() for r in range(4)]


def test_schedules_on_four_threads(card):
    """One schedule of each module of parallel/ on a 4-thread group at
    N=1024: equal to the same schedule's plain path, to the single-card
    kernels' result, and (limb-sharded) with the zeroed q_last row."""
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan
    from gemini_seal_tpu_torch.parallel import (behz_sp, bootstrap_sp, keyswitch_sp, ntt_sp,
                                                pipeline_csp)

    n = 1024
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [30] * 10))
    parms.set_n_special_primes(2)
    parms.set_random_seed(tuple(range(91, 99)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device=card)
    kg = T.KeyGenerator(ctx, device=card)
    enc = T.Encryptor(ctx, kg.public_key(), device=card)
    cod = T.CKKSEncoder(ctx, device=card)
    ct = enc.encrypt(cod.encode([0.5, -0.25, 0.125], 2.0 ** 28)).data
    a = torch.stack([ct, ct.roll(1, -1)])
    rk = kg.relin_keys().stacked(2)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    tables = ctx.first_context_data().ntt_tables
    n_ct = plan.n_ct_rns

    got, want = _four_threads(card, lambda g, x: [ntt_sp.ntt_forward_sharded(x, tables, g),
                                                  ntt_sp.ntt_inverse_sharded_4step(x, tables, g)],
                              _split(a, -1))
    for k, ref in enumerate((tn.ntt_forward(a, tables), tn.ntt_inverse(a, tables))):
        assert torch.equal(torch.cat([o[k] for o in got], -1), ref)
        assert torch.equal(torch.cat([o[k] for o in want], -1), ref)

    single = T.build_ckks_mul_relin_rescale(ctx, device=card)(a, a, rk)
    got, want = _four_threads(card, lambda g, x: keyswitch_sp.ckks_mul_relin_rescale_limb_sharded(
        x, x, rk, plan, g), _split(a, -2))
    joined = torch.cat(got, -2)
    assert torch.equal(joined, torch.cat(want, -2))
    assert torch.equal(joined[..., :n_ct - 1, :], single)
    assert bool((joined[..., n_ct - 1, :] == 0).all())

    got, want = _four_threads(card, lambda g, x, k: pipeline_csp.ckks_mul_relin_rescale_coeff_sharded(
        x, x, k, plan, g), _split(a, -1), _split(rk, -1))
    assert torch.equal(torch.cat(got, -1), single) and torch.equal(torch.cat(want, -1), single)

    diag = {d: [0.1 * ((i + d) % 5) for i in range(n // 2)] for d in (0, 1, -3)}
    tool = ctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(d) for d in sorted(diag) if d]
    keys = kg.galois_keys(elts).stacked(*elts)
    mv = bootstrap_sp.build_ckks_matvec_limb_sharded(ctx, diag, 2.0 ** 28, cod, 4, device=card)
    ref = T.build_ckks_matvec(ctx, diag, 2.0 ** 28, cod, device=card)(a, keys)
    got, want = _four_threads(card, lambda g, x: mv(g, x, keys), _split(a, -2))
    assert torch.equal(torch.cat(got, -2), ref) and torch.equal(torch.cat(want, -2), ref)

    bp = T.EncryptionParameters(T.SchemeType.BFV)
    bp.set_poly_modulus_degree(n)
    bp.set_coeff_modulus(T.CoeffModulus.create(n, [40] * 5))
    bp.set_plain_modulus(T.PlainModulus.batching(n, 20))
    bp.set_random_seed(tuple(range(8)))
    bctx = T.SealContext(bp, sec_level=T.SecLevelType.none, device=card)
    bkg = T.KeyGenerator(bctx, device=card)
    bct = T.Encryptor(bctx, bkg.public_key(), device=card).encrypt(
        T.BatchEncoder(bctx, device=card).encode(list(range(n)))).data
    b = torch.stack([bct, bct.roll(2, -1)])
    brk = bkg.relin_keys().stacked(2)
    ref = T.build_bfv_mul_relin(bctx, device=card)(b, b, brk)
    got, want = _four_threads(card, lambda g, x: behz_sp.bfv_mul_relin_limb_sharded(
        x, x, brk, bctx, g), _split(b, -2))
    assert torch.equal(torch.cat(got, -2), ref) and torch.equal(torch.cat(want, -2), ref)


@pytest.mark.gpu4
def test_nccl_group_on_four_cards():
    """The NCCL DistGroup, one spawned process per card: the limb- and the
    coefficient-sharded steps at N=64 equal the single-card step."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from torch_helpers import ckks64_context, nccl_bodies

    from gemini_seal_tpu_torch.parallel.comm import spawn

    card = torch.device("cuda", 0)
    ctx = ckks64_context(card)
    kg = T.KeyGenerator(ctx, device=card)
    enc = T.Encryptor(ctx, kg.public_key(), device=card)
    cod = T.CKKSEncoder(ctx, device=card)
    a = torch.stack([enc.encrypt(cod.encode([0.5 * (i + 1)], 2.0 ** 25)).data for i in range(2)])
    rk = kg.relin_keys().stacked(2)
    single = T.build_ckks_mul_relin_rescale(ctx, device=card)(a, a, rk).cpu()
    res = spawn(nccl_bodies, 4, "nccl", a.cpu(), rk.cpu())
    limb = torch.cat([r[0][0] for r in res], -2)
    assert torch.equal(limb[..., :-1, :], single) and bool((limb[..., -1, :] == 0).all())
    assert torch.equal(torch.cat([r[0][1] for r in res], -1), single)
    assert res[0][1]["count"]["all-gather"] == 1 and res[0][1]["count"]["all-to-all"] == 16


# --------------------------------------------------------------------------
# K12 ntt_mxu: the four-step NTT's digit-pair passes on the int8 tensor cores
# --------------------------------------------------------------------------

from gemini_seal_tpu_torch.ops import ntt_mxu as tmx  # noqa: E402

_MXU = {}


def _mxu(log_n, bits, card):
    """(moduli, K12 tables, K1 tables) at N = 2^log_n, built once a module."""
    key = (log_n, tuple(bits))
    if key not in _MXU:
        pools = {b: get_primes(max(1 << log_n, 1024), b, bits.count(b)) for b in set(bits)}
        mods = [pools[b].pop() for b in bits]
        _MXU[key] = (mods, tmx.build_mxu_ntt_tables(log_n, mods, device=card),
                     tn.build_ntt_tables(log_n, mods).to(card))
    return _MXU[key]


@pytest.mark.parametrize("log_n,bits", [(4, (30, 30)), (8, (50, 40)), (10, (54, 54)),
                                        (13, (50, 40, 40, 50)), (14, (50, 40, 40, 40, 40, 50)),
                                        (16, (50, 40))])
@pytest.mark.parametrize("fill", ["random", "zero", "top"])
def test_ntt_mxu_kernel(card, log_n, bits, fill):
    """K12's two passes in both directions equal their plain versions and
    K1's canonical transforms: K below 32 (log N = 4, 8, 10: the zero-padded
    k32 step), both pass modes, 54-bit moduli (eight data digits), mixed
    40/50-bit limbs, and K = 512 at N = 65536 (the int32 headroom); inputs
    random over the lazy range [0, 2p), all 0, and all 2p - 1."""
    mods, mx, k1 = _mxu(log_n, list(bits), card)
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    lead = (2,) if log_n == 16 else (3, 2)
    x = _res(rng, mods, lead, n, 2)
    if fill != "random":
        for li, p in enumerate(mods):
            x[..., li, :] = 0 if fill == "zero" else 2 * p - 1
    xt = to_tensor(x, card)
    before = cuda.LAUNCHES["ntt_mxu"]
    got_f, want_f = _both(tmx.ntt_forward_mxu, xt, mx)
    got_i, want_i = _both(tmx.ntt_inverse_mxu, xt, mx)
    assert cuda.LAUNCHES["ntt_mxu"] == before + 4
    assert torch.equal(got_f, want_f) and torch.equal(got_i, want_i)
    assert torch.equal(got_f, tn.ntt_forward(xt, k1))
    assert torch.equal(got_i, tn.ntt_inverse(xt, k1))


@pytest.mark.parametrize("log_n,bits", [(10, (54, 54)), (14, (50, 40, 40, 40, 40, 50))])
def test_ntt_mxu_round_trip(card, log_n, bits):
    mods, mx, _ = _mxu(log_n, list(bits), card)
    x = to_tensor(_res(np.random.default_rng(7), mods, (4, 2), 1 << log_n), card)
    assert torch.equal(tmx.ntt_inverse_mxu(tmx.ntt_forward_mxu(x, mx), mx), x)
    assert torch.equal(tmx.ntt_forward_mxu(tmx.ntt_inverse_mxu(x, mx), mx), x)


@pytest.mark.parametrize("log_n,bits", [(10, (54, 54)), (13, (50, 40, 40, 50)),
                                        (14, (50, 40, 40, 40, 40, 50))])
def test_ntt_mxu_kernel_from_a_new_thread(card, log_n, bits):
    """K12 launched from a thread whose first CUDA call it is (a server's
    worker, a data loader), after the main thread has launched it: the
    tensor-map encode needs the context that the runtime makes current on
    a thread only at its first runtime call.  Both directions equal their
    plain versions, as they do from the main thread."""
    import threading

    mods, mx, _ = _mxu(log_n, list(bits), card)
    xt = to_tensor(_res(np.random.default_rng(11), mods, (3, 2), 1 << log_n, 2), card)
    first = tmx.ntt_forward_mxu(xt, mx)
    box = {}

    def run():
        try:
            box["out"] = (tmx.ntt_forward_mxu(xt, mx), tmx.ntt_inverse_mxu(xt, mx))
            torch.cuda.synchronize()
        except BaseException as exc:  # raised on the main thread below
            box["err"] = exc

    before = cuda.LAUNCHES["ntt_mxu"]
    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "err" in box:
        raise box["err"]
    assert cuda.LAUNCHES["ntt_mxu"] == before + 4
    with plain_versions():
        want = (tmx.ntt_forward_mxu(xt, mx), tmx.ntt_inverse_mxu(xt, mx))
    assert torch.equal(box["out"][0], want[0]) and torch.equal(box["out"][1], want[1])
    assert torch.equal(first, want[0])


def test_ntt_mxu_unbuilt_kernel_raises(card, monkeypatch, tmp_path):
    """With no build of K12 and no compiler, a CUDA tensor raises: nothing
    falls back to the plain version."""
    mods, mx, _ = _mxu(8, [50, 40], card)
    x = to_tensor(_res(np.random.default_rng(1), mods, (2,), 256), card)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda, "BUILD_REPORT", {})
    monkeypatch.setattr(cuda, "_FUNCS", {})
    monkeypatch.setattr(cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(tmx, "mxu_pass_plain", no_plain)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tmx.ntt_forward_mxu(x, mx)


@pytest.mark.parametrize("log_n,bits", [(4, (30, 40, 50, 54)), (11, (50, 40, 54, 30)),
                                        (13, (40, 50, 40, 50)), (15, (54, 40))])
def test_ntt_mxu_kernel_limb_digit_counts(card, log_n, bits):
    """Limbs of different digit counts in one launch (30, 40, 50 and
    54-bit primes: 4 x 5, 6 x 6, 7 x 7 and 7 x 8 pairs), with K below 32
    (N = 16: N1 = 8, N2 = 2, the zero-padded k32 step), N1 != N2 (N =
    2048, 8192) and K = 256 (W from device memory): every pass of both
    directions equals its plain version, which equals the plain sum over
    the limbs' own pairs."""
    mods, mx, k1 = _mxu(log_n, list(bits), card)
    n = 1 << log_n
    x = _res(np.random.default_rng(log_n + 5), mods, (3,), n, 2)
    x[0, :, 0] = [2 * p - 1 for p in mods]
    xt = to_tensor(x, card)
    xr = xt.reshape(3, len(mods), mx.n1, mx.n2)
    assert len(set(zip(mx.limb_ndig_w["fwd_col"], mx.limb_ndig_x))) > 1
    for w, cx, tw in ((mx.fwd_col, "A", (mx.fwd_twist, mx.fwd_twist_shoup)),
                      (mx.fwd_row, "B", None),
                      (mx.inv_row, "B", (mx.inv_twist, mx.inv_twist_shoup)),
                      (mx.inv_col, "A", None)):
        got, want = _both(tmx.mxu_pass, xr, w, mx, cx, twist=tw)
        assert torch.equal(got, want), cx
        assert torch.equal(want, tmx.mxu_pass_plain_limbs(xr, w, mx, cx, twist=tw))
    assert torch.equal(tmx.ntt_forward_mxu(xt, mx), tn.ntt_forward(xt, k1))


@pytest.mark.parametrize("n", [2, 32, 1024, 4096, 8192, 65536, 131072])
@pytest.mark.parametrize("L", [1, 3, 64])
def test_infty_norm_kernel_tile_edges(card, n, L):
    """K10 at its cluster geometry: the centred lift's edges 0, p >> 1,
    (p >> 1) + 1 and p - 1 planted at the first and last coefficient of
    every 16-byte step of every CTA's tile and at the row's ends, the row's
    largest magnitude in different tiles in different rows; one launch,
    equal to the plain version."""
    from gemini_seal_tpu_torch.ops import dyadic

    geo = dyadic.infty_norm_geometry(n)
    span = 2 * geo["threads"]
    base = [get_primes(max(n, 1024), b, 1)[0] for b in (60, 50, 40)]
    mods = [base[li % 3] for li in range(L)]
    limbs = LimbConstants.from_moduli(mods, card)
    rows = 2 if L == 64 and n >= 65536 else 3
    rng = np.random.default_rng(n * 7 + L)
    x = _res(rng, mods, (rows,), n)
    for li, p in enumerate(mods):
        edges = [0, p >> 1, (p >> 1) + 1, p - 1]
        for s, start in enumerate(range(0, n, span)):
            x[s % rows, li, start] = edges[s % 4]
            x[(s + 1) % rows, li, min(start + span, n) - 1] = edges[(s + 1) % 4]
        x[0, li, -1] = p >> 1
    before = cuda.LAUNCHES["infty_norm"]
    got, want = _both(dyadic.poly_infty_norm, to_tensor(x, card), limbs)
    assert cuda.LAUNCHES["infty_norm"] == before + 1
    assert got.shape == (rows, L) and torch.equal(got, want)


def test_infty_norm_kernel_refuses_more_limbs_than_a_launch_takes(card):
    from gemini_seal_tpu_torch.ops import dyadic

    mods = get_primes(1024, 40, 65)
    limbs = LimbConstants.from_moduli(mods, card)
    x = to_tensor(_res(np.random.default_rng(0), mods, (1,), 64), card)
    with pytest.raises(ValueError, match="65 limbs"):
        dyadic.poly_infty_norm(x, limbs)


def _zoo_context(scheme, device):
    parms = T.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(1024)
    if scheme == T.SchemeType.BFV:
        parms.set_coeff_modulus(T.CoeffModulus.create(1024, [40, 40, 40]))
        parms.set_plain_modulus(T.PlainModulus.batching(1024, 20))
    else:
        parms.set_coeff_modulus(T.CoeffModulus.create(1024, [50, 40, 40, 40, 50]))
    parms.set_random_seed(tuple(range(8)))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)


@pytest.mark.parametrize("form", ["dense_hoisted", "dense_bsgs", "mlp", "conv2d_mc",
                                  "bfv_matvec"])
def test_zoo_builders_match_cpu(card, form):
    """The model zoo's builders at N=1024 on the card against the same
    builders on the CPU (plain versions), bit for bit, with keys and the
    batch-2 input made on the CPU; every kernel call on the card sees
    contiguous tensors (torch_helpers.contiguous_calls, and the wrappers'
    own check)."""
    from torch_helpers import contiguous_calls

    bfv = form == "bfv_matvec"
    scheme = T.SchemeType.BFV if bfv else T.SchemeType.CKKS
    devs = ("cpu", card)
    ctxs = {d: _zoo_context(scheme, d) for d in devs}
    kg = T.KeyGenerator(ctxs["cpu"], device="cpu")
    tool = ctxs["cpu"].first_context_data().galois_tool
    rng = np.random.default_rng(21)
    n, slots = 1024, 512
    if bfv:
        cods = {d: T.BatchEncoder(ctxs[d], device=d) for d in devs}
        M = rng.integers(0, 1 << 16, size=(8, 8))
        diags = {d: [int(M[i % 8, (i + d) % 8]) for i in range(n)] for d in range(8)}
        fns = {d: T.build_bfv_matvec(ctxs[d], diags, cods[d], device=d) for d in devs}
        steps = list(range(1, 8))
        pt = cods["cpu"].encode(rng.integers(0, 1 << 16, size=n).tolist())
    else:
        cods = {d: T.CKKSEncoder(ctxs[d], device=d) for d in devs}
        M = rng.uniform(-0.5, 0.5, size=(8, 8))
        diags = {d: [M[i % 8, (i + d) % 8] for i in range(slots)] for d in range(8)}
        bias = rng.uniform(-0.2, 0.2, size=slots).tolist()
        if form.startswith("dense"):
            fns = {d: T.build_ckks_dense_layer(ctxs[d], diags, bias, 2.0 ** 40, cods[d],
                                               bsgs=form == "dense_bsgs", device=d)[0]
                   for d in devs}
            steps = fns["cpu"].rot_steps
        elif form == "mlp":
            layers = [(diags, bias, "square"), (diags, bias, None)]
            fns = {d: T.build_ckks_mlp(ctxs[d], layers, 2.0 ** 40, cods[d], device=d)[0]
                   for d in devs}
            steps = fns["cpu"].rot_steps[0]
        else:
            K = rng.uniform(-0.4, 0.4, size=(2, 2, 3, 3))
            fns = {d: T.build_ckks_conv2d_mc(ctxs[d], K, 8, 8, 2.0 ** 40, cods[d],
                                             activation="square", periodic=True, device=d)[0]
                   for d in devs}
            steps = fns["cpu"].rot_steps
        pt = cods["cpu"].encode(rng.uniform(-1, 1, size=slots).tolist(), 2.0 ** 40)
    ct = T.Encryptor(ctxs["cpu"], kg.public_key(), device="cpu").encrypt(pt)
    a = torch.stack([ct.data] * 2)
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts).stacked(*elts)
    rk = kg.relin_keys().stacked(2)

    def call(d, *args):
        if bfv:
            return fns[d](args[0], args[1])
        return fns[d](args[0], [args[1]] * 2 if form == "mlp" else args[1], args[2])

    want = call("cpu", a, gk, rk)
    before = cuda.LAUNCHES.copy()
    with contiguous_calls():
        got = call(card, a.to(card), gk.to(card), rk.to(card))
    torch.cuda.synchronize()
    launched = {k: cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched["ntt"] and launched["contract"] and launched["galois"]
    assert launched["tensor_product"] == (0 if bfv else 1)     # one square at most
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("terms", [32, 64, 63, 126])
def test_contract_pairwise_at_the_matmul_shape(card, terms):
    """K3's pairwise mode at the d=32 matmul's contraction (batch 16, level
    1 of [50, 40 x 4, 50]: four primes, N=2048): d terms (components 0 and
    2), 2d (component 1) and, with several heads, 2d - 1 and 2(2d - 1),
    against contract_plain, with every residue of one row at p - 1."""
    from gemini_seal_tpu_torch.ops.modops import contract_plain

    mods = T.CoeffModulus.create(2048, [50, 40, 40, 40, 40, 50])[:4]
    mods = [m.value for m in mods]
    limbs = LimbConstants.from_moduli(mods, card)
    rng = np.random.default_rng(terms)
    a = _res(rng, mods, (16, terms), 2048)
    w = _res(rng, mods, (16, terms), 2048)
    a[3], w[3] = (np.asarray(mods, dtype=np.uint64) - 1)[None, :, None], \
        (np.asarray(mods, dtype=np.uint64) - 1)[None, :, None]
    at, wt = to_tensor(a, card).unsqueeze(0), to_tensor(w, card)
    consts = [limbs.p.reshape(-1), limbs.ratio0.reshape(-1), limbs.ratio1.reshape(-1)]
    before = cuda.LAUNCHES.copy()
    got = contract_mulmod_128(at, wt, *consts, pairwise=True)
    assert cuda.LAUNCHES["contract:pairwise"] == before["contract:pairwise"] + 1
    assert cuda.LAUNCHES["contract"] == before["contract"] + 1
    want = contract_plain(at, wt, *consts)
    torch.cuda.synchronize()
    assert got.shape == (1, 16, 4, 2048) and torch.equal(got, want)


def _compare_context(n, bits, device):
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, bits))
    parms.set_random_seed(tuple(range(8)))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)


@pytest.mark.parametrize("form", ["sign", "max", "sqrt", "matmul_h1", "matmul_h4",
                                  "attention_h1", "attention_h2"])
def test_compare_attention_builders_match_cpu(card, form):
    """The comparison builders, the matmul and attention at the CPU tests'
    rings (sign and max at N=256 on [50, 40 x 13, 50], sqrt on [50, 40 x 14,
    50]; the matmul at d=4, N=32 and four heads at N=128; attention at d=4,
    N=32 and two heads at N=64, 18 levels) on the card against the same
    builders on the CPU, bit for bit, keys and batch-2 inputs made on the
    CPU; every kernel call on the card sees contiguous tensors."""
    from torch_helpers import contiguous_calls

    sc = 2.0 ** 40
    heads = 4 if form == "matmul_h4" else 2 if form == "attention_h2" else 1
    if form.startswith("matmul"):
        n, bits = 32 * heads, [50, 40, 40, 40, 40, 50]
    elif form.startswith("attention"):
        n, bits = 32 * heads, [50] + [40] * 18 + [50]
    else:
        n, bits = 256, [50] + [40] * (14 if form == "sqrt" else 13) + [50]
    devs = ("cpu", card)
    ctxs = {d: _compare_context(n, bits, d) for d in devs}
    cods = {d: T.CKKSEncoder(ctxs[d], device=d) for d in devs}
    kg = T.KeyGenerator(ctxs["cpu"], device="cpu")
    enc = T.Encryptor(ctxs["cpu"], kg.public_key(), device="cpu")
    rng = np.random.default_rng(37)
    slots = n // 2

    def ct(lo, hi):
        return torch.stack([enc.encrypt(cods["cpu"].encode(
            rng.uniform(lo, hi, slots).tolist(), sc)).data] * 2)

    rk = kg.relin_keys().stacked(2)
    if form == "sign":
        fns = {d: T.build_ckks_sign(ctxs[d], sc, cods[d], device=d)[0] for d in devs}
        args = (ct(-1, 1), rk)
    elif form == "max":
        fns = {d: T.build_ckks_max(ctxs[d], sc, cods[d], device=d)[0] for d in devs}
        args = (ct(-0.5, 0.5), ct(-0.5, 0.5), rk)
    elif form == "sqrt":
        fns = {d: T.build_ckks_sqrt(ctxs[d], sc, cods[d], iters=3, device=d)[0] for d in devs}
        args = (ct(0.5, 1.5), rk)
    else:
        if form.startswith("matmul"):
            fns = {d: T.build_ckks_matmul_square(ctxs[d], 4, sc, cods[d], heads=heads,
                                                 device=d)[0] for d in devs}
            steps = fns["cpu"].rot_steps
            cts = (ct(-1, 1), ct(-1, 1))
        else:
            built = {d: T.build_ckks_attention(ctxs[d], 4, sc, cods[d], iters=4, heads=heads,
                                               device=d) for d in devs}
            fns = {d: b[0] for d, b in built.items()}
            steps = built["cpu"][3]
            cts = (ct(-0.5, 0.5), ct(-0.5, 0.5), ct(-0.5, 0.5))
        elts = ctxs["cpu"].first_context_data().galois_tool.get_elts_from_steps(steps)
        args = cts + (kg.galois_keys(elts).stacked(*elts), rk)
    want = fns["cpu"](*args)
    before = cuda.LAUNCHES.copy()
    with contiguous_calls():
        got = fns[card](*(x.to(card) for x in args))
    torch.cuda.synchronize()
    launched = {k: cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched["ntt"] and launched["contract"] and launched["elementwise"]
    if form.startswith(("matmul", "attention")):
        assert launched["contract:pairwise"] == 3 * (1 if form.startswith("matmul") else 2)
        assert launched["galois"]
    assert torch.equal(got.cpu(), want)


def test_server_on_the_card_matches_cpu(card):
    """The wire-to-wire server (models/serving.py) on the card against the
    same server on the CPU: the dense layer at N=1024 on the same blobs (full
    and seed-compressed), submit and the pipelined submit_stream (pinned
    staging, side-stream upload), byte for byte; the loaders place the data
    on the card."""
    from gemini_seal_tpu_torch import serialization as ser
    from gemini_seal_tpu_torch.models.serving import EncryptedComputeServer

    devs = ("cpu", card)
    ctxs = {d: _zoo_context(T.SchemeType.CKKS, d) for d in devs}
    kg = T.KeyGenerator(ctxs["cpu"], device="cpu")
    cods = {d: T.CKKSEncoder(ctxs[d], device=d) for d in devs}
    rng = np.random.default_rng(43)
    M = rng.uniform(-0.5, 0.5, size=(8, 8))
    diags = {d: [M[i % 8, (i + d) % 8] for i in range(512)] for d in range(8)}
    bias = rng.uniform(-0.2, 0.2, size=512).tolist()
    built = {d: T.build_ckks_dense_layer(ctxs[d], diags, bias, 2.0 ** 40, cods[d], device=d)
             for d in devs}
    elts = ctxs["cpu"].first_context_data().galois_tool.get_elts_from_steps(
        built["cpu"][0].rot_steps)
    keys = [kg.galois_keys(elts).stacked(*elts), kg.relin_keys().stacked(2)]
    servers = {d: EncryptedComputeServer(ctxs[d], built[d][0], keys, built[d][1], True,
                                         built[d][2], 4, device=d) for d in devs}
    pts = cods["cpu"].encode_batch([rng.uniform(-1, 1, 512).tolist() for _ in range(4)],
                                   2.0 ** 40)
    full = [ser.save(T.Encryptor(ctxs["cpu"], kg.public_key(), device="cpu").encrypt(p))
            for p in pts]
    enc = T.Encryptor(ctxs["cpu"], secret_key=kg.secret_key, device="cpu")
    seeded = [enc.encrypt_symmetric_serializable(p).save() for p in pts]
    batches = [full, full[:3], seeded, seeded[:1]]
    want = [servers["cpu"].submit(b) for b in batches]
    before = cuda.LAUNCHES.copy()
    got = [servers[card].submit(b) for b in batches]
    launched = {k: cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched["ntt"] and launched["contract"] and launched["galois"]
    assert got == want
    assert list(servers[card].submit_stream(batches)) == want
    assert ser.load_ciphertext(seeded[0], ctxs[card]).data.device.type == "cuda"


@pytest.mark.parametrize("scheme", ["BFV", "CKKS"])
def test_decrypt_batch_on_the_card(card, scheme):
    """Decryptor.decrypt_batch on the card: one pass over the batch (K4; K1,
    K3 and K7 for BFV) equal to per-ciphertext decrypt on the card and to
    decrypt_batch on the CPU, bit for bit."""
    sch = getattr(T.SchemeType, scheme)
    devs = ("cpu", card)
    ctxs = {d: _zoo_context(sch, d) for d in devs}
    kg = T.KeyGenerator(ctxs["cpu"], device="cpu")
    decs = {d: T.Decryptor(ctxs[d], T.SecretKey(kg.secret_key.data.to(d),
                                                kg.secret_key.parms_id), device=d)
            for d in devs}
    enc = T.Encryptor(ctxs["cpu"], kg.public_key(), device="cpu")
    rng = np.random.default_rng(3)
    if sch == T.SchemeType.BFV:
        cod = T.BatchEncoder(ctxs["cpu"], device="cpu")
        cts = [enc.encrypt(cod.encode(rng.integers(0, 1 << 16, 1024).tolist())) for _ in range(3)]
    else:
        cod = T.CKKSEncoder(ctxs["cpu"], device="cpu")
        cts = [enc.encrypt(cod.encode(rng.uniform(-1, 1, 512).tolist(), 2.0 ** 40))
               for _ in range(3)]
    meta = (cts[0].parms_id, cts[0].is_ntt_form, cts[0].scale)
    data = torch.stack([c.data for c in cts])
    want = decs["cpu"].decrypt_batch(data, *meta)
    before = cuda.LAUNCHES.copy()
    got = decs[card].decrypt_batch(data.to(card), *meta)
    torch.cuda.synchronize()
    launched = {k: cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched["elementwise"]
    if sch == T.SchemeType.BFV:   # CKKS ciphertexts are in NTT form: no transform
        assert launched["ntt"] and launched["contract"] and launched["scale_round"]
    for g, w, c in zip(got, want, cts):
        assert g.data.device.type == "cuda" and torch.equal(g.data.cpu(), w.data)
        one = decs[card].decrypt(T.Ciphertext(c.data.to(card), *meta))
        assert torch.equal(one.data, g.data)
