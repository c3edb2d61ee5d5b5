"""Carry-across from the JAX package's objects.

The JAX package (gemini_seal_tpu) keeps residues as np.uint64 arrays.
These functions take those arrays and plain ints (never the JAX package's
objects: this module imports nothing of it) and return the port's objects
on a device, so keys and ciphertexts made by the JAX package run through
the port's pipelines:

    ct = ciphertext_from_arrays(ctx, jct.data, jct.parms_id,
                                jct.is_ntt_form, jct.scale)
    rk = relin_keys_from_array(ctx, np.stack([pk.data.data for pk in jrk.key(2)]))
    gk = galois_keys_from_arrays(ctx, {e: np.stack([pk.data.data for pk in jgk.key(e)])
                                       for e in elts})
    stack = galois_stack_from_array(ctx, jstack)      # [R, nb, 2, L_key, N]
    sk = secret_key_from_array(ctx, jkg.secret_key.data)
    pt = plaintext_from_array(ctx, jpt.data)          # a BFV plaintext
"""

from __future__ import annotations

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import GaloisKeys, PublicKey, RelinKeys, SecretKey
from .ops.backend import to_tensor
from .params import PARMS_ID_ZERO

__all__ = ["ciphertext_from_arrays", "relin_keys_from_array", "galois_keys_from_arrays",
           "galois_stack_from_array", "secret_key_from_array", "plaintext_from_array"]


def _parms_id(parms_id) -> tuple:
    return tuple(int(w) for w in parms_id)


def _level_shape(context: SealContext, parms_id):
    cd = context.get_context_data(_parms_id(parms_id))
    if cd is None:
        raise ValueError("parms_id is not valid for the context")
    return len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree


def ciphertext_from_arrays(context: SealContext, data, parms_id,
                           is_ntt_form: bool, scale: float) -> Ciphertext:
    """u64[size, L, N] ciphertext data + metadata -> port Ciphertext."""
    data = np.asarray(data, dtype=np.uint64)
    L, n = _level_shape(context, parms_id)
    if data.ndim != 3 or data.shape[1:] != (L, n):
        raise ValueError(f"ciphertext data {data.shape} does not match the level's [size, {L}, {n}]")
    return Ciphertext(to_tensor(data, context.device), _parms_id(parms_id),
                      bool(is_ntt_form), float(scale))


def _kswitch_key(context: SealContext, data, what: str):
    """u64[n_bundles, 2, L_key, N] -> one key's list of bundle PublicKeys."""
    data = np.asarray(data, dtype=np.uint64)
    pid = context.key_parms_id
    L, n = _level_shape(context, pid)
    if data.ndim != 4 or data.shape[1:] != (2, L, n):
        raise ValueError(f"{what} data {data.shape} does not match [nb, 2, {L}, {n}]")
    return [PublicKey(Ciphertext(to_tensor(d, context.device), pid, True, 1.0), pid)
            for d in data]


def relin_keys_from_array(context: SealContext, data) -> RelinKeys:
    """u64[n_bundles, 2, L_key, N] relinearization key (for s^2) -> RelinKeys."""
    rk = RelinKeys()
    rk.keys = [_kswitch_key(context, data, "relin key")]
    rk.parms_id = context.key_parms_id
    return rk


def galois_keys_from_arrays(context: SealContext, keys) -> GaloisKeys:
    """{galois_elt: u64[n_bundles, 2, L_key, N]} -> GaloisKeys."""
    if not keys:
        raise ValueError("no Galois keys given")
    gk = GaloisKeys()
    gk.keys = [[] for _ in range(max(GaloisKeys.get_index(int(e)) for e in keys) + 1)]
    for elt, data in keys.items():
        gk.keys[GaloisKeys.get_index(int(elt))] = _kswitch_key(context, data, "Galois key")
    gk.parms_id = context.key_parms_id
    return gk


def galois_stack_from_array(context: SealContext, data) -> torch.Tensor:
    """u64[R, n_bundles, 2, L_key, N] stacked Galois keys (the JAX
    package's stack for the hoisted rotations, plain or counter-rotated by
    its prepermute_galois_stack), of a CKKS or BFV context -> the int64
    tensor that the rotate-many steps take."""
    data = np.asarray(data, dtype=np.uint64)
    L, n = _level_shape(context, context.key_parms_id)
    if data.ndim != 5 or data.shape[2:] != (2, L, n):
        raise ValueError(f"Galois key stack {data.shape} does not match [R, nb, 2, {L}, {n}]")
    return to_tensor(data, context.device)


def secret_key_from_array(context: SealContext, data) -> SecretKey:
    """u64[L_key, N] NTT-form secret key -> SecretKey."""
    data = np.asarray(data, dtype=np.uint64)
    pid = context.key_parms_id
    if data.shape != _level_shape(context, pid):
        raise ValueError("secret key data does not match the key level")
    return SecretKey(to_tensor(data, context.device), pid)


def plaintext_from_array(context: SealContext, data) -> Plaintext:
    """u64[count] BFV plaintext coefficients (power basis, count <= N) ->
    Plaintext with parms_id zero."""
    data = np.asarray(data, dtype=np.uint64)
    n = context.first_context_data().parms.poly_modulus_degree
    if data.ndim != 1 or not 0 < data.shape[0] <= n:
        raise ValueError(f"plaintext data {data.shape} is not [count <= {n}]")
    return Plaintext(to_tensor(data, context.device), PARMS_ID_ZERO)
