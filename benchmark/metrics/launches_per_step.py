"""Kernel launches a step: the program's own counter (ops.cuda.LAUNCHES,
raised right after each launch of a hand-written kernel) over the window's
steps."""


def read(obs):
    return obs.launches_per_step if obs.launches_per_step > 0 else None
