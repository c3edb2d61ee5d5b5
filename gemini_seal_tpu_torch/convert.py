"""Carry-across from the JAX package's objects.

The JAX package (gemini_seal_tpu) keeps residues as np.uint64 arrays.
These functions take those arrays and plain ints (never the JAX package's
objects: this module imports nothing of it) and return the port's objects
on a device, so keys and ciphertexts made by the JAX package run through
the port's pipelines:

    ct = ciphertext_from_arrays(ctx, jct.data, jct.parms_id,
                                jct.is_ntt_form, jct.scale)
    rk = relin_keys_from_array(ctx, np.stack([pk.data.data for pk in jrk.key(2)]))
    sk = secret_key_from_array(ctx, jkg.secret_key.data)
"""

from __future__ import annotations

import numpy as np

from .ciphertext import Ciphertext
from .context import SealContext
from .keys import PublicKey, RelinKeys, SecretKey
from .ops.backend import to_tensor

__all__ = ["ciphertext_from_arrays", "relin_keys_from_array", "secret_key_from_array"]


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


def relin_keys_from_array(context: SealContext, data) -> RelinKeys:
    """u64[n_bundles, 2, L_key, N] relinearization key (for s^2) -> RelinKeys."""
    data = np.asarray(data, dtype=np.uint64)
    pid = context.key_parms_id
    L, n = _level_shape(context, pid)
    if data.ndim != 4 or data.shape[1:] != (2, L, n):
        raise ValueError(f"relin key data {data.shape} does not match [nb, 2, {L}, {n}]")
    rk = RelinKeys()
    rk.keys = [[PublicKey(Ciphertext(to_tensor(d, context.device), pid, True, 1.0), pid)
                for d in data]]
    rk.parms_id = pid
    return rk


def secret_key_from_array(context: SealContext, data) -> SecretKey:
    """u64[L_key, N] NTT-form secret key -> SecretKey."""
    data = np.asarray(data, dtype=np.uint64)
    pid = context.key_parms_id
    if data.shape != _level_shape(context, pid):
        raise ValueError("secret key data does not match the key level")
    return SecretKey(to_tensor(data, context.device), pid)
