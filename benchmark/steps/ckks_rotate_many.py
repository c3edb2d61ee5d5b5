"""Hoisted CKKS rotations of one batch by every step of the mix, one batch
a step: models/pipelines.build_ckks_rotate_many (one mod-up of c1 feeds
every rotation's key switch), with the default Galois keys.

One op is one rotation of one ciphertext.  The answer of rotation r of row
b is the row's slots moved left by steps[r], at the same level and scale."""

import torch

from benchmark.reference.schemes import rotate_slots
from benchmark.scheme import data_primes

SCHEME = "ckks"
OPERANDS = 1


def _elts(ctx, traffic):
    return ctx.first_context_data().galois_tool.get_elts_from_steps(list(traffic["steps"]))


def keys(T, ctx, kg, traffic):
    elts = _elts(ctx, traffic)
    return {"galois": kg.galois_keys(elts).stacked(*elts)}


def build(T, ctx, traffic, keys):
    step = T.build_ckks_rotate_many(ctx, list(traffic["steps"]), device=ctx.device)
    gk = keys["galois"]
    return lambda ct: step(ct, gk)


def ops_per_step(traffic):
    return traffic["batch"] * len(traffic["steps"])


def outputs(out):
    """[steps, batch, 2, L, N] -> [steps * batch, 2, L, N]."""
    return out.reshape((-1,) + tuple(out.shape[-3:]))


def expected(msgs, traffic, cfg):
    m = torch.as_tensor(msgs[0])
    return torch.cat([rotate_slots(m, k, bfv_rows=False) for k in traffic["steps"]])


def level(cfg):
    data = data_primes(cfg)
    return data, 2.0 ** cfg["scale_bits"]


def unchanged(operands, traffic):
    ct = operands[0]
    return ct.unsqueeze(0).expand((len(traffic["steps"]),) + tuple(ct.shape)).contiguous()
