"""Device milliseconds a step: the step span's interval on the stream
(CUDA events at its entry and exit), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms()
