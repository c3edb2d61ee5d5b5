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


def encrypt_zero_symmetric(
    secret_key: SecretKey, context, parms_id, is_ntt_form: bool
) -> Ciphertext:
    """(c0, c1) = ([-(a s + e)]_q, a) (reference: rlwe.cpp:204-302).

    c1 is drawn from its own stream: a derived one when the parameter seed
    is pinned (reproducible tests), fresh entropy otherwise.  The seeded
    (serializable) dataflow comes with the serialization slice.
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

    rng_error = parms_rng(parms)
    if parms.random_seed is not None:
        c1_rng = Blake2xbPRNG(tuple((s ^ 0xA5A5A5A5A5A5A5A5) for s in parms.random_seed))
    else:
        c1_rng = BlakePRNGFactory().create()

    # a (= c1) uniform, sampled directly in the ciphertext's domain
    c1 = to_tensor(sample_poly_uniform(c1_rng, coeff_modulus, n), dev)
    e = to_tensor(sample_poly_normal(rng_error, moduli, n), dev)

    sk = secret_key.data[:L, :].contiguous()
    c0 = dyadic_product(sk, c1, limbs)
    if is_ntt_form:
        e = ntt_forward(e, tables)
    else:
        c0 = ntt_inverse(c0, tables)
        c1 = ntt_inverse(c1, tables)
    c0 = negate_poly(add_poly(e, c0, limbs), limbs)

    return Ciphertext(
        data=torch.stack([c0, c1]),
        parms_id=cd.parms_id,
        is_ntt_form=is_ntt_form,
        scale=1.0,
    )
