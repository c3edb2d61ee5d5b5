"""The program's spans of the traced window (gemini_seal_tpu_torch/tracing.py),
read for the per-layer metrics: each a mean over the step spans.

A `--trace 1` run opens a torch.profiler session around its traced window,
which turns the program's spans on; the program keeps their record until
the next session starts.  A program without spans, or a session that
recorded no step span, gives None."""

from __future__ import annotations

STEP = "step."


def record():
    """The program's span record, or None where the program has none."""
    try:
        from gemini_seal_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.summary()


def per_step_ms(names=None, field: str = "device_s"):
    """Milliseconds a step of `field` ("device_s" or "host_s") summed over
    the spans `names` (None: the step spans themselves)."""
    rec = record()
    if not rec:
        return None
    steps = {k: v for k, v in rec.items() if k.startswith(STEP)}
    count = sum(v["count"] for v in steps.values())
    if not count:
        return None
    spans = steps if names is None else {k: rec[k] for k in names if k in rec}
    return 1e3 * float(sum(v[field] for v in spans.values())) / count
