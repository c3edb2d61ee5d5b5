"""Card tests: each hand-written kernel against its plain PyTorch version on
the same inputs on the card, bit for bit, and the fused step, the train
step and the hoisted rotations against the plain path.  They need a CUDA card and skip without one; on a machine with
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
    mods = _mods(1 << 15, (50,))
    tables = tn.build_ntt_tables(15, mods).to(card)
    with pytest.raises(ValueError, match="shared memory"):
        tn.ntt_forward(torch.zeros((1, 1 << 15), dtype=torch.int64, device=card), tables)
    tables = tn.build_ntt_tables(10, _mods(1024)).to(card)
    x = torch.zeros((3, 2048), dtype=torch.int64, device=card)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tn.ntt_forward(x, tables)


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
