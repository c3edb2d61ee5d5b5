"""A kernel family's share of its roofline over the traced window: the
least time of its calls at the card's peaks (peaks.json; work/<family>.py
counts each call's bytes and multiplies from its shapes) over the family's
device time, both for one step."""

from __future__ import annotations

import json
import os

from .capture import bound_s

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str):
    with open(os.path.join(HERE, "peaks.json")) as fh:
        return json.load(fh).get(device_name)


def share(obs, family: str):
    """Percent, or None where the trace, the work count or the card's peaks
    are missing."""
    pk = peaks(obs.device_name)
    calls = obs.work.get(family)
    if not pk or not calls or not obs.trace or not obs.traced_steps:
        return None
    device_s = obs.trace["family_s"].get(family, 0.0) / obs.traced_steps
    if device_s <= 0:
        return None
    return 100.0 * bound_s(calls, pk) / device_s
