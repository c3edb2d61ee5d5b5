"""Device milliseconds a step in work that is no hand-written kernel of the
program (torch's copies, gathers, cats and fills), from the traced window."""


def read(obs):
    if not obs.trace or not obs.traced_steps:
        return None
    return 1e3 * obs.trace["glue_s"] / obs.traced_steps
