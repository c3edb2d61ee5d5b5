"""Share of the traced window in which no kernel, copy or fill ran on the
card, in percent."""


def read(obs):
    if not obs.trace or obs.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - obs.trace["busy_s"] / obs.trace["window_s"])
