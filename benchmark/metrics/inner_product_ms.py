"""Device milliseconds a step in span `keyswitch.inner_product` (the key
contraction of the key switch), over the traced window's steps."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(("keyswitch.inner_product",))
