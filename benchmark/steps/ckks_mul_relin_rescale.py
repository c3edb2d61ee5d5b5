"""CKKS multiply + relinearize + rescale of ciphertext pairs, one batch a
step: models/pipelines.build_ckks_mul_relin_rescale (the fused form merges
the rescale into the key switch's mod-down when the mix asks for it).

One op is the product of one pair.  The answer of row b is the slotwise
product of its two messages, at the next level and the scale
scale^2 / (the dropped prime)."""

from benchmark.scheme import data_primes

SCHEME = "ckks"
OPERANDS = 2


def keys(T, ctx, kg, traffic):
    return {"relin": kg.relin_keys().stacked(2)}


def build(T, ctx, traffic, keys):
    step = T.build_ckks_mul_relin_rescale(ctx, fused=traffic["fused"], device=ctx.device)
    rk = keys["relin"]
    return lambda a, b: step(a, b, rk)


def ops_per_step(traffic):
    return traffic["batch"]


def outputs(out):
    """[items, 2, L, N] ciphertexts in the order of expected()."""
    return out


def expected(msgs, traffic, cfg):
    return msgs[0] * msgs[1]


def level(cfg):
    """(primes, scale) of the outputs."""
    data = data_primes(cfg)
    scale = 2.0 ** cfg["scale_bits"]
    return data[:-1], scale * scale / data[-1]


def unchanged(operands, traffic):
    """What a step that leaves its state as it was would hand back, at the
    output's shape: the first operand at the output's level."""
    return operands[0][..., :-1, :].contiguous()
