"""Device milliseconds a step in span `keyswitch.moddown` (the mod-downs by
the special primes), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(("keyswitch.moddown",))
