"""K-family `ntt`: its share of its roofline in the traced window (see
benchmark/roofline.py and work/ntt.py)."""

from benchmark.roofline import share


def read(obs):
    return share(obs, "ntt")
