"""The plain reference against exact integer arithmetic and against the
program's own NTT, encoders and encryptor at small rings (CPU)."""

import random

import numpy as np
import pytest
import torch

import gemini_seal_tpu_torch as T
from benchmark.reference import rns, schemes
from gemini_seal_tpu_torch.ops.ntt import ntt_forward as port_ntt
from gemini_seal_tpu_torch.ops.ntt import ntt_inverse as port_intt

PRIMES_16K = [281474976546817, 562949951619073]


def test_mulmod_matches_python_ints():
    rng = random.Random(3)
    for p in PRIMES_16K + [786433, (1 << 51) - 129]:
        a = [rng.randrange(p) for _ in range(2000)] + [p - 1, 0, 1]
        b = [rng.randrange(p) for _ in range(2000)] + [p - 1, p - 1, 1]
        got = rns.mulmod(torch.tensor(a), torch.tensor(b), torch.tensor(p))
        assert got.tolist() == [x * y % p for x, y in zip(a, b)]


@pytest.mark.parametrize("n,bits", [(1024, [50, 40, 40, 50]), (2048, [44, 44, 44])])
def test_ntt_matches_the_programs_bit_for_bit(n, bits):
    kcd = _context(T.SchemeType.CKKS, n, bits).key_context_data()
    primes = [m.value for m in kcd.parms.coeff_modulus]
    rng = np.random.default_rng(1)
    x = torch.tensor(np.stack([rng.integers(0, p, (3, n)) for p in primes], axis=1))
    fwd = rns.ntt_forward(x, primes)
    assert torch.equal(fwd, port_ntt(x, kcd.ntt_tables))
    assert torch.equal(rns.ntt_inverse(fwd, primes), x)
    assert torch.equal(port_intt(fwd, kcd.ntt_tables), x)


def test_crt_and_scale_round_match_python_ints():
    primes = [m.value for m in T.CoeffModulus.create(1024, [50, 40, 40, 50])]
    Q = 1
    for p in primes:
        Q *= p
    rng = random.Random(5)
    vals = [rng.randrange(-(1 << 52), 1 << 52) for _ in range(500)] + [0, 1, -1, Q // 2 - 5]
    res = torch.tensor([[v % p for p in primes] for v in vals]).T.reshape(1, len(primes), -1)
    got = rns.crt_centered(res, primes)[0]
    for g, v in zip(got.tolist(), vals):
        assert g == float(v) or abs(g - v) <= abs(v) * 2 ** -52
    t = 786433
    xs = [rng.randrange(Q) for _ in range(500)]
    res = torch.tensor([[x % p for p in primes] for x in xs]).T.reshape(1, len(primes), -1)
    got = rns.scale_round_mod_t(res, primes, t)[0].tolist()
    assert got == [((t * x + Q // 2) // Q) % t for x in xs]


def _context(scheme, n, bits, t=None):
    parms = T.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, bits))
    if t:
        parms.set_plain_modulus(t)
    parms.set_random_seed(tuple(range(8)))
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device="cpu")


def _keys(ctx, rng):
    n = ctx.key_context_data().parms.poly_modulus_degree
    primes = [m.value for m in ctx.key_context_data().parms.coeff_modulus]
    s = torch.tensor(rng.integers(-1, 2, n))
    sk = T.SecretKey(data=schemes.secret_key_ntt(s, primes), parms_id=ctx.key_parms_id)
    return T.KeyGenerator(ctx, secret_key=sk, device="cpu"), sk


def test_ckks_decrypt_decode_and_step_answers():
    rng = np.random.default_rng(7)
    ctx = _context(T.SchemeType.CKKS, 1024, [50, 40, 40, 50])
    kg, sk = _keys(ctx, rng)
    enc = T.Encryptor(ctx, kg.public_key(), device="cpu")
    encoder = T.CKKSEncoder(ctx, device="cpu")
    scale = 2.0 ** 40
    m = rng.uniform(-1, 1, (2, 512))
    pts = encoder.encode_stack(list(m), scale, ctx.first_parms_id)
    cts = torch.stack([enc.encrypt(T.Plaintext(data=pts[i], parms_id=ctx.first_parms_id,
                                               scale=scale)).data for i in range(2)])
    primes = [q.value for q in ctx.first_context_data().parms.coeff_modulus]
    got = schemes.ckks_decrypt_decode(cts, sk.data, primes, scale, 5)
    assert np.abs(got.numpy() - m).max() < 1e-8
    # the slots agree with the program's own decode
    dec = T.Decryptor(ctx, sk, device="cpu")
    ct0 = T.Ciphertext(cts[0], ctx.first_parms_id, True, scale)
    assert np.abs(np.array(encoder.decode(dec.decrypt(ct0))) - got[0].real.numpy()).max() < 1e-9
    cd = ctx.first_context_data()
    elts = cd.galois_tool.get_elts_from_steps([1, 3])
    out = T.build_ckks_rotate_many(ctx, [1, 3], device="cpu")(cts, kg.galois_keys(elts).stacked(*elts))
    for r, k in enumerate([1, 3]):
        got = schemes.ckks_decrypt_decode(out[r].contiguous(), sk.data, primes, scale, 5)
        want = schemes.rotate_slots(torch.tensor(m), k, bfv_rows=False)
        assert (got - want).abs().max() < 1e-7


def test_bfv_decrypt_decode_and_step_answers():
    rng = np.random.default_rng(8)
    t = 786433
    ctx = _context(T.SchemeType.BFV, 1024, [44, 44, 44], t)
    kg, sk = _keys(ctx, rng)
    enc = T.Encryptor(ctx, kg.public_key(), device="cpu")
    be = T.BatchEncoder(ctx, device="cpu")
    m = rng.integers(0, t, (2, 1024))
    cts = torch.stack([enc.encrypt(p).data for p in be.encode_batch([r.tolist() for r in m])])
    primes = [q.value for q in ctx.first_context_data().parms.coeff_modulus]
    assert np.array_equal(schemes.bfv_decrypt_decode(cts, sk.data, primes, t, 5).numpy(), m)
    out = T.build_bfv_mul_relin(ctx, device="cpu")(cts, cts.flip(0).contiguous(),
                                                   kg.relin_keys().stacked(2))
    got = schemes.bfv_decrypt_decode(out, sk.data, primes, t, 5).numpy()
    assert np.array_equal(got, m * m[::-1] % t)
    cd = ctx.first_context_data()
    elts = cd.galois_tool.get_elts_from_steps([2, 5])
    out = T.build_bfv_rotate_many(ctx, [2, 5], device="cpu")(cts,
                                                             kg.galois_keys(elts).stacked(*elts))
    for r, k in enumerate([2, 5]):
        got = schemes.bfv_decrypt_decode(out[r].contiguous(), sk.data, primes, t, 5)
        assert torch.equal(got, schemes.rotate_slots(torch.tensor(m), k, bfv_rows=True))


def test_ckks_encode_is_the_decoders_inverse_and_the_programs_encoding():
    rng = np.random.default_rng(9)
    ctx = _context(T.SchemeType.CKKS, 1024, [50, 40, 40, 50])
    primes = [q.value for q in ctx.first_context_data().parms.coeff_modulus]
    scale = 2.0 ** 40
    m = rng.uniform(-1, 1, (3, 512))
    pt = schemes.ckks_encode_ntt(torch.tensor(m), primes, scale, 5)
    prog = T.CKKSEncoder(ctx, device="cpu").encode_stack(list(m), scale, ctx.first_parms_id)
    assert torch.equal(pt, prog)
    zero = torch.zeros_like(pt)
    got = schemes.ckks_decrypt_decode(torch.stack([pt, zero], dim=1),
                                      torch.zeros(len(primes), 1024, dtype=torch.int64),
                                      primes, scale, 5)
    assert np.abs(got.numpy() - m).max() < 1e-9


def test_bfv_encode_is_the_decoders_inverse_and_the_programs_scaling():
    rng = np.random.default_rng(10)
    t = 786433
    ctx = _context(T.SchemeType.BFV, 1024, [44, 44, 44], t)
    primes = [q.value for q in ctx.first_context_data().parms.coeff_modulus]
    m = rng.integers(0, t, (3, 1024))
    scaled = schemes.bfv_encode_scaled(torch.tensor(m), primes, t, 5)
    # the program's encoding added onto a zero ciphertext: Delta m in c0
    be = T.BatchEncoder(ctx, device="cpu")
    ev = T.Evaluator(ctx, device="cpu")
    zero = T.Ciphertext(torch.zeros(2, len(primes), 1024, dtype=torch.int64),
                        ctx.first_parms_id, False, 1.0)
    prog = torch.stack([ev.add_plain(zero, p).data[0] for p in be.encode_batch(
        [r.tolist() for r in m])])
    assert torch.equal(scaled, prog)
    ct = torch.stack([scaled, torch.zeros_like(scaled)], dim=1)
    s_ntt = torch.zeros(len(primes), 1024, dtype=torch.int64)
    assert np.array_equal(schemes.bfv_decrypt_decode(ct, s_ntt, primes, t, 5).numpy(), m)
