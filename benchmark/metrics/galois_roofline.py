"""K-family `galois`: its share of its roofline in the traced window (see
benchmark/roofline.py and work/galois.py)."""

from benchmark.roofline import share


def read(obs):
    return share(obs, "galois")
