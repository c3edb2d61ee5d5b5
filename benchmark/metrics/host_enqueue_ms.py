"""Mean host milliseconds to enqueue one step (the step call and its event,
no synchronize), over the untraced steps of the window: the compositions'
and the kernel wrappers' Python."""


def read(obs):
    if not obs.enqueue_s:
        return None
    return 1e3 * sum(obs.enqueue_s) / len(obs.enqueue_s)
