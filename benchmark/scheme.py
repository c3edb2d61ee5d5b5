"""The general generator: a cell's inputs from its configuration, its mix
and the seed.

From `--seed` alone it draws the ternary secret key, one message a
ciphertext, for each input batch and operand, and the seed of the
randomness that encrypts them.  The program receives the secret key in NTT
form (computed by the reference's own NTT) and derives its relin and
Galois keys from it with fresh randomness of its own, as a deployment does
(a pinned parameter seed would give every key bundle the same a and e).
The input ciphertexts are the benchmark's own: each row a symmetric
encryption with its own uniform c1 and error, built by the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.rns import addmod, mulmod, ntt_forward, ntt_inverse, submod
from .reference.schemes import bfv_encode_scaled, ckks_encode_ntt, secret_key_ntt

SECURITY = ("tc128", "tc192", "tc256", "none")
# SEAL's error distribution: a normal of deviation 3.2, clipped at 6 deviations
NOISE_SIGMA = 3.2
NOISE_BOUND = 19
ENCRYPT_ROWS = 32


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def slots_of(cfg: dict) -> int:
    n = cfg["poly_modulus_degree"]
    return n // 2 if cfg["scheme"] == "ckks" else n


def draw(seed: int, cfg: dict, traffic: dict, operands: int) -> dict:
    """The secret key, the messages of a run (messages[i][k] is operand k
    of input batch i, [batch, slots]), the early step whose output is
    checked, and the seed of the encryptions' randomness."""
    rng = rng_of(seed)
    n = cfg["poly_modulus_degree"]
    secret = rng.integers(-1, 2, n)
    shape = (traffic["input_batches"], operands, traffic["batch"], slots_of(cfg))
    if cfg["scheme"] == "ckks":
        msgs = rng.uniform(-1.0, 1.0, shape)
    else:
        msgs = rng.integers(0, cfg["plain_modulus"], shape)
    # the early step whose output is checked beside the last of each batch
    early = int(rng.integers(0, 2 * traffic["in_flight"]))
    noise_seed = int(rng.integers(0, 1 << 63))
    return {"secret": secret, "messages": msgs, "early_step": early, "noise_seed": noise_seed}


def context(T, cfg: dict, device):
    """The program's SealContext for the configuration, its randomness
    unpinned."""
    scheme = {"ckks": T.SchemeType.CKKS, "bfv": T.SchemeType.BFV}[cfg["scheme"]]
    parms = T.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(cfg["poly_modulus_degree"])
    parms.set_coeff_modulus([T.Modulus(p) for p in cfg["coeff_modulus"]])
    parms.set_n_special_primes(cfg["n_special_primes"])
    if cfg["scheme"] == "bfv":
        parms.set_plain_modulus(cfg["plain_modulus"])
    if cfg["security"] not in SECURITY:
        raise ValueError(f"unknown security level {cfg['security']!r}")
    sec = getattr(T.SecLevelType, cfg["security"])
    ctx = T.SealContext(parms, sec_level=sec, device=device)
    if not ctx.parameters_set():
        raise ValueError("the program refuses the configuration's parameters")
    return ctx


def data_primes(cfg: dict):
    """The primes of the first data level: the key level less its special
    primes."""
    return cfg["coeff_modulus"][:len(cfg["coeff_modulus"]) - cfg["n_special_primes"]]


def secret_key(cfg: dict, secret):
    """The benchmark's secret key in NTT form at the key level (the
    reference's own NTT), as the program's KeyGenerator takes it."""
    return secret_key_ntt(torch.tensor(secret, dtype=torch.int64), cfg["coeff_modulus"])


def keygen(T, ctx, sk_ntt, device):
    """A KeyGenerator over the benchmark's secret key."""
    sk = T.SecretKey(data=sk_ntt.to(device), parms_id=ctx.key_parms_id)
    return T.KeyGenerator(ctx, secret_key=sk, device=device)


def encrypt(cfg: dict, drawn: dict, sk_ntt, device):
    """Every message batch of the draw, encoded and encrypted under the
    secret key: one int64 [rows, 2, L, N] tensor a batch, in the order of
    drawn["messages"] flattened (input batch, then operand).

    Row by row c1 = a, uniform mod each prime, and c0 = -a s + e + m, with e
    SEAL's clipped normal error and m the encoded message (CKKS: NTT form at
    the configured scale; BFV: power basis, m scaled by Q/t), all drawn on
    the device from the draw's noise seed, in blocks of rows."""
    primes = data_primes(cfg)
    L, n = len(primes), cfg["poly_modulus_degree"]
    p = torch.tensor(primes, dtype=torch.int64, device=device).reshape(L, 1)
    s = sk_ntt[:L].to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(drawn["noise_seed"])
    out = []
    for msgs in drawn["messages"].reshape((-1,) + drawn["messages"].shape[-2:]):
        blocks = []
        for lo in range(0, msgs.shape[0], ENCRYPT_ROWS):
            m = torch.as_tensor(msgs[lo:lo + ENCRYPT_ROWS], device=device)
            rows = m.shape[0]
            a = torch.stack([torch.randint(0, int(q), (rows, n), generator=gen, device=device)
                             for q in primes], dim=1)
            e = torch.round(torch.randn((rows, 1, n), generator=gen, device=device,
                                        dtype=torch.float64) * NOISE_SIGMA)
            e = torch.remainder(e.clamp(-NOISE_BOUND, NOISE_BOUND).long(), p)
            ss = s.expand_as(a)
            if cfg["scheme"] == "ckks":
                msg = ckks_encode_ntt(m, primes, 2.0 ** cfg["scale_bits"], cfg["slot_generator"])
                as_ = mulmod(a, ss, p)
                e = ntt_forward(e, primes)
            else:
                msg = bfv_encode_scaled(m.long(), primes, cfg["plain_modulus"],
                                        cfg["slot_generator"])
                as_ = ntt_inverse(mulmod(ntt_forward(a, primes), ss, p), primes)
            c0 = addmod(submod(e, as_, p), msg, p)
            blocks.append(torch.stack([c0, a], dim=1))
        out.append(torch.cat(blocks).contiguous())
    return out
