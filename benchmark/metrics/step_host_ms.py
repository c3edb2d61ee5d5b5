"""Host milliseconds a step inside the step span, over the traced window's
steps (under the profiler: compare with host_enqueue_ms, untraced, and with
step_device_ms)."""

from benchmark.spans import per_step_ms


def read(obs):
    return per_step_ms(field="host_s")
