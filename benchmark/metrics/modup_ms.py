"""Device milliseconds a step in span `keyswitch.modup` (the mod-up,
compute_modup_digits), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(("keyswitch.modup",))
