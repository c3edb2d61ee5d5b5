"""Validity checks for the port's objects against a context.

Port of gemini_seal_tpu/valcheck.py (reference: native/src/seal/
valcheck.{h,cpp}): metadata checks (parms_id membership, shape congruence),
buffer checks (sizes), value bounds, and the combined is_valid_for.  Residue
tensors hold u64 bit patterns in int64 (ops/backend.py), so a residue with
bit 63 set reads as negative and would pass a signed ``x < p``: every bound
is checked on the host, on the np.uint64 view of the data, as the JAX
package checks its arrays.  The checks accept objects whose data is a
tensor (pulled to the host) or a host np.uint64 array (the loaders check
wire data before they upload it).
"""

from __future__ import annotations

import numpy as np

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import KSwitchKeys, PublicKey, SecretKey
from .modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN
from .ops.backend import host_u64
from .params import PARMS_ID_ZERO, SchemeType

__all__ = ["is_metadata_valid_for", "is_buffer_valid", "is_data_valid_for", "is_valid_for"]


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def _moduli(cd) -> np.ndarray:
    return np.array([m.value for m in cd.parms.coeff_modulus], dtype=np.uint64)


def is_metadata_valid_for(obj, context: SealContext, allow_pure_key_level: bool = False) -> bool:
    """Shape/parms_id congruence (valcheck.h:32-90)."""
    if context is None or not context.parameters_set():
        return False
    if isinstance(obj, Plaintext):
        if obj.parms_id == PARMS_ID_ZERO:
            return obj.coeff_count <= context.first_context_data().parms.poly_modulus_degree
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        expected = (len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree)
        return tuple(obj.data.shape) == expected or _numel(obj.data) == expected[0] * expected[1]
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        if (not allow_pure_key_level and obj.parms_id == context.key_parms_id
                and context.using_keyswitching):
            # ordinary ciphertexts live at or below the first data level; only
            # key-switching keys sit at the key level (valcheck.cpp:70-84)
            return False
        if not CIPHERTEXT_SIZE_MIN <= obj.size <= CIPHERTEXT_SIZE_MAX:
            return False
        return (obj.coeff_modulus_size == len(cd.parms.coeff_modulus)
                and obj.poly_modulus_degree == cd.parms.poly_modulus_degree)
    if isinstance(obj, SecretKey):
        if obj.parms_id != context.key_parms_id:
            return False
        cd = context.key_context_data()
        return tuple(obj.data.shape) == (len(cd.parms.coeff_modulus),
                                         cd.parms.poly_modulus_degree)
    if isinstance(obj, PublicKey):
        return (obj.parms_id == context.key_parms_id and obj.data.is_ntt_form
                and is_metadata_valid_for(obj.data, context, allow_pure_key_level=True))
    if isinstance(obj, KSwitchKeys):
        if obj.parms_id != context.key_parms_id:
            return False
        return all(is_metadata_valid_for(pk, context) for row in obj.keys for pk in row)
    return False


def is_buffer_valid(obj) -> bool:
    """Size congruence of the raw buffer (valcheck.h:92-130)."""
    if isinstance(obj, Plaintext):
        return _numel(obj.data) > 0
    if isinstance(obj, Ciphertext):
        return obj.data.ndim == 3 and obj.data.shape[0] == obj.size
    if isinstance(obj, (SecretKey, PublicKey)):
        return True
    if isinstance(obj, KSwitchKeys):
        return all(is_buffer_valid(pk.data) for row in obj.keys for pk in row)
    return False


def is_data_valid_for(obj, context: SealContext) -> bool:
    """Value bounds per limb, unsigned (valcheck.h:132-170); reads the data
    on the host."""
    if isinstance(obj, Plaintext):
        if obj.parms_id == PARMS_ID_ZERO:
            parms = context.first_context_data().parms
            if parms.scheme == SchemeType.BFV:
                return bool(np.all(host_u64(obj.data) < np.uint64(parms.plain_modulus.value)))
            return True
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        mods = _moduli(cd)
        return bool(np.all(host_u64(obj.data).reshape(len(mods), -1) < mods[:, None]))
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        return bool(np.all(host_u64(obj.data) < _moduli(cd)[None, :, None]))
    if isinstance(obj, SecretKey):
        return bool(np.all(host_u64(obj.data) < _moduli(context.key_context_data())[:, None]))
    if isinstance(obj, PublicKey):
        return is_data_valid_for(obj.data, context)
    if isinstance(obj, KSwitchKeys):
        return all(is_data_valid_for(pk.data, context) for row in obj.keys for pk in row)
    return False


def is_valid_for(obj, context: SealContext) -> bool:
    """Full check (valcheck.h:172-197)."""
    return (is_metadata_valid_for(obj, context) and is_buffer_valid(obj)
            and is_data_valid_for(obj, context))
