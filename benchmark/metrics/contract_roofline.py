"""K-family `contract`: its share of its roofline in the traced window (see
benchmark/roofline.py and work/contract.py)."""

from benchmark.roofline import share


def read(obs):
    return share(obs, "contract")
