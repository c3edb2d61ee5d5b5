"""RLWE zero-encryptions (reference: native/src/seal/util/rlwe.cpp:131-302).

Port of gemini_seal_tpu/rlwe.py.  Sampling stays on the host (the exact
draw streams of utils/prng); the samples are uploaded to the context's
device and the NTTs and ring ops run there.  The pk/sk tensors at the key
level are limb-prefix-sliced for encryptions at lower levels: the RNS chain
drops moduli from the tail, so rows [0:L] of a key-level [L_key, N] tensor
are exactly the lower level's limbs.
"""

from __future__ import annotations

import torch

from .ciphertext import Ciphertext
from .keys import PublicKey, SecretKey
from .ops.backend import to_tensor
from .ops.dyadic import add_poly, dyadic_product, negate_poly
from .ops.ntt import ntt_forward, ntt_inverse
from .utils.blake2 import Blake2xbPRNG
from .utils.prng import (
    BlakePRNGFactory,
    sample_poly_normal,
    sample_poly_ternary,
    sample_poly_uniform,
)

__all__ = ["encrypt_zero_asymmetric", "encrypt_zero_symmetric", "parms_rng"]


def parms_rng(parms) -> Blake2xbPRNG:
    """The parameter set's PRNG factory (seeded when parms.random_seed is
    pinned, fresh system entropy otherwise)."""
    return BlakePRNGFactory(parms.random_seed).create()


def encrypt_zero_asymmetric(
    public_key: PublicKey, context, parms_id, is_ntt_form: bool
) -> Ciphertext:
    """(pk[j] * u + e[j])_j with u ternary, e Gaussian
    (reference: rlwe.cpp:131-202)."""
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    moduli = [m.value for m in parms.coeff_modulus]
    L = len(moduli)
    n = parms.poly_modulus_degree
    tables = cd.ntt_tables
    limbs = cd.limb_constants
    dev = context.device
    size = public_key.data.size

    rng = parms_rng(parms)

    # u <- R_3, to NTT domain
    u_ntt = ntt_forward(to_tensor(sample_poly_ternary(rng, moduli, n), dev), tables)

    pk = public_key.data.data[:, :L, :]  # limb-prefix at this level
    cs = []
    for j in range(size):
        c = dyadic_product(u_ntt, pk[j].contiguous(), limbs)
        if not is_ntt_form:
            c = ntt_inverse(c, tables)
        cs.append(c)

    # e_j <- chi, added in the target domain
    out = []
    for j in range(size):
        e = to_tensor(sample_poly_normal(rng, moduli, n), dev)
        if is_ntt_form:
            e = ntt_forward(e, tables)
        out.append(add_poly(cs[j], e, limbs))

    return Ciphertext(
        data=torch.stack(out),
        parms_id=cd.parms_id,
        is_ntt_form=is_ntt_form,
        scale=1.0,
    )


# host draws (a, e) of the pinned-seed zero-encryptions, by (seed, moduli, N)
_PINNED_DRAWS = {}
_PINNED_DRAWS_MAX = 8


def _symmetric_draws(parms, coeff_modulus, moduli, n, c1_seed=None):
    """The uniform a and the error e of one zero-encryption, as host arrays.

    With a pinned parameter seed both streams start afresh at every call
    (as in the JAX package), so every call draws the same a and e: they are
    drawn once per (seed, moduli, N) and reused, which keeps a key set of
    thousands of bundles from repeating the same host sampling.  With a c1
    seed, a comes from that seed's own stream (the seeded dataflow).
    """
    if c1_seed is not None:
        a = sample_poly_uniform(Blake2xbPRNG(tuple(int(s) for s in c1_seed)), coeff_modulus, n)
        if parms.random_seed is None:
            return a, sample_poly_normal(parms_rng(parms), moduli, n)
        return a, _symmetric_draws(parms, coeff_modulus, moduli, n)[1]
    if parms.random_seed is None:
        return (sample_poly_uniform(BlakePRNGFactory().create(), coeff_modulus, n),
                sample_poly_normal(parms_rng(parms), moduli, n))
    key = (tuple(parms.random_seed), tuple(moduli), n)
    draws = _PINNED_DRAWS.get(key)
    if draws is None:
        c1_rng = Blake2xbPRNG(tuple((s ^ 0xA5A5A5A5A5A5A5A5) for s in parms.random_seed))
        draws = (sample_poly_uniform(c1_rng, coeff_modulus, n),
                 sample_poly_normal(parms_rng(parms), moduli, n))
        if len(_PINNED_DRAWS) >= _PINNED_DRAWS_MAX:
            _PINNED_DRAWS.pop(next(iter(_PINNED_DRAWS)))
        _PINNED_DRAWS[key] = draws
    return draws


def encrypt_zero_symmetric(
    secret_key: SecretKey, context, parms_id, is_ntt_form: bool, c1_seed=None
) -> Ciphertext:
    """(c0, c1) = ([-(a s + e)]_q, a) (reference: rlwe.cpp:204-302).

    c1 is drawn from its own stream: a derived one when the parameter seed
    is pinned (reproducible tests), fresh entropy otherwise.  With `c1_seed`
    the seeded dataflow is used (rlwe.cpp save_seed=true): the raw uniform
    sample is the stored c1 in the ciphertext's own domain, so that a
    receiver regenerates it from the seed alone; for BFV the sample is read
    as the power basis and transformed only to compute c0.
    """
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    coeff_modulus = parms.coeff_modulus
    moduli = [m.value for m in coeff_modulus]
    L = len(moduli)
    n = parms.poly_modulus_degree
    tables = cd.ntt_tables
    limbs = cd.limb_constants
    dev = context.device

    # a (= c1) uniform, sampled directly in the ciphertext's domain
    a_host, e_host = _symmetric_draws(parms, coeff_modulus, moduli, n, c1_seed)
    c1 = to_tensor(a_host, dev)
    e = to_tensor(e_host, dev)
    seeded_bfv = c1_seed is not None and not is_ntt_form

    sk = secret_key.data[:L, :].contiguous()
    c0 = dyadic_product(sk, ntt_forward(c1, tables) if seeded_bfv else c1, limbs)
    if is_ntt_form:
        e = ntt_forward(e, tables)
    else:
        c0 = ntt_inverse(c0, tables)
        if not seeded_bfv:
            c1 = ntt_inverse(c1, tables)
    c0 = negate_poly(add_poly(e, c0, limbs), limbs)

    return Ciphertext(
        data=torch.stack([c0, c1]),
        parms_id=cd.parms_id,
        is_ntt_form=is_ntt_form,
        scale=1.0,
    )
