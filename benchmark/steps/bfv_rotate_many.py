"""Hoisted BFV row rotations of one batch by every step of the mix, one
batch a step: models/pipelines.build_bfv_rotate_many (the same hoisted
_rotate_many as the CKKS form, in the power basis), default Galois keys.

One op is one rotation of one ciphertext.  The answer of rotation r of row
b is each of the row's two slot rows moved left by steps[r]."""

import torch

from benchmark.reference.schemes import rotate_slots
from benchmark.scheme import data_primes

SCHEME = "bfv"
OPERANDS = 1


def _elts(ctx, traffic):
    return ctx.first_context_data().galois_tool.get_elts_from_steps(list(traffic["steps"]))


def keys(T, ctx, kg, traffic):
    elts = _elts(ctx, traffic)
    return {"galois": kg.galois_keys(elts).stacked(*elts)}


def build(T, ctx, traffic, keys):
    step = T.build_bfv_rotate_many(ctx, list(traffic["steps"]), device=ctx.device)
    gk = keys["galois"]
    return lambda ct: step(ct, gk)


def ops_per_step(traffic):
    return traffic["batch"] * len(traffic["steps"])


def outputs(out):
    return out.reshape((-1,) + tuple(out.shape[-3:]))


def expected(msgs, traffic, cfg):
    m = torch.as_tensor(msgs[0])
    return torch.cat([rotate_slots(m, k, bfv_rows=True) for k in traffic["steps"]])


def level(cfg):
    data = data_primes(cfg)
    return data, None


def unchanged(operands, traffic):
    ct = operands[0]
    return ct.unsqueeze(0).expand((len(traffic["steps"]),) + tuple(ct.shape)).contiguous()
