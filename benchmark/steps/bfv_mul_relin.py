"""BFV multiply + relinearize of ciphertext pairs by BEHZ, one batch a step:
models/pipelines.build_bfv_mul_relin.

One op is the product of one pair.  The answer of row b is the slotwise
product of its two messages mod t, at the same level."""

from benchmark.scheme import data_primes

SCHEME = "bfv"
OPERANDS = 2


def keys(T, ctx, kg, traffic):
    return {"relin": kg.relin_keys().stacked(2)}


def build(T, ctx, traffic, keys):
    step = T.build_bfv_mul_relin(ctx, device=ctx.device)
    rk = keys["relin"]
    return lambda a, b: step(a, b, rk)


def ops_per_step(traffic):
    return traffic["batch"]


def outputs(out):
    return out


def expected(msgs, traffic, cfg):
    return (msgs[0] * msgs[1]) % cfg["plain_modulus"]


def level(cfg):
    data = data_primes(cfg)
    return data, None


def unchanged(operands, traffic):
    return operands[0]
