"""Device milliseconds a step in spans `behz.extend` (the operands' lifts to
q and Bsk) and `behz.floor` (the inverse transforms, the multiply by t,
fast_floor, fastbconv_sk), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(("behz.extend", "behz.floor"))
