"""K-family `behz`: its share of its roofline in the traced window (see
benchmark/roofline.py and work/behz.py)."""

from benchmark.roofline import share


def read(obs):
    return share(obs, "behz")
