"""The flagship step with example tensors: the port's twin of the JAX
package's ``__graft_entry__.entry()``.

    step, (ct_a, ct_b, relin_key, galois_key) = entry()   # on the card
    out = step(ct_a, ct_b, relin_key, galois_key)

The step is build_ckks_train_step (multiply + relinearize + rescale,
rotate by one slot, add) at N=1024, coeff modulus bits [40, 30, 40], one
special prime and seed range(51, 59); the tensors are the encryptions of
[0.5, -1.25, 2.0] and its reverse at scale 2^30, and the keys for s^2 and
for the rotation by one step.  Under the pinned seed every tensor equals
the JAX package's bit for bit.
"""

from __future__ import annotations

from .context import SealContext
from .encoders import CKKSEncoder
from .encryptor import Encryptor
from .keygenerator import KeyGenerator
from .models.pipelines import build_ckks_train_step
from .modulus import CoeffModulus, SecLevelType
from .params import EncryptionParameters, SchemeType

__all__ = ["entry"]


def _build(n, bits, seed, device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_random_seed(seed)
    ctx = SealContext(parms, sec_level=SecLevelType.none, device=device)
    kg = KeyGenerator(ctx, device=device)
    enc = Encryptor(ctx, kg.public_key(), device=device)
    encoder = CKKSEncoder(ctx, device=device)
    elt = ctx.first_context_data().galois_tool.get_elt_from_step(1)
    rk = kg.relin_keys()
    gk = kg.galois_keys([elt])

    scale = 2.0 ** 30
    vals = [0.5, -1.25, 2.0]
    ct_a = enc.encrypt(encoder.encode(vals, scale)).data
    ct_b = enc.encrypt(encoder.encode(vals[::-1], scale)).data
    step = build_ckks_train_step(ctx, rotate_steps=1, device=device)
    return step, (ct_a, ct_b, rk.stacked(2), gk.stacked(elt)), ctx


def entry(device=None):
    """(fn, example_args): the flagship forward step and its inputs, on
    ``device`` (None means the card)."""
    step, args, _ = _build(n=1024, bits=[40, 30, 40], seed=tuple(range(51, 59)),
                           device=device)
    return step, args
