"""Device milliseconds a step in span `rns.rescale` (the rounded division by
the last prime), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(("rns.rescale",))
