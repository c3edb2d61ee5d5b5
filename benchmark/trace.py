"""The device trace of a traced window, reduced to what the per-layer
metrics read.

torch.profiler records the card's kernels, copies and fills (CUPTI) and the
benchmark's own host ranges ("bench_window" around the traced steps,
"enqueue" around each step call, "wait" around each wait for a step's
completion).  The trace is exported once, read here, and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_window"
HOST_LABELS = ("enqueue", "wait")
TOP = 10

_MANGLED = re.compile(r"_Z(\d+)")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def function_name(name: str) -> str:
    """The bare function identifier of a kernel's trace name, demangled
    ("void ntt_kernel<false, 13>(NttArgs)", "(anonymous namespace)::f(..)")
    or mangled ("_Z10ntt_kernel...")."""
    m = _MANGLED.match(name)
    if m:
        start = m.end()
        return name[start:start + int(m.group(1))]
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    m = _IDENT.match(name)
    return m.group(0) if m else name


def family_of(name: str, families: dict):
    fn = function_name(name)
    for fam, names in families.items():
        if fn in names:
            return fam
    return None


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce(events, families: dict) -> dict:
    """Window length, busy time, per-family and glue device time, the top
    device operations and the idle time by what the host was doing, all in
    seconds, from chrome-trace events (timestamps in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat") != "gpu_user_annotation"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {}
    if windows:
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    spans = []
    fam_us, op_us = {}, {}
    glue_us = 0.0
    for e in dev:
        lo = max(float(e["ts"]), w0)
        hi = min(float(e["ts"]) + float(e["dur"]), w1)
        if hi <= lo:
            continue
        spans.append((lo, hi))
        d = hi - lo
        fam = family_of(e["name"], families) if e.get("cat") == "kernel" else None
        if fam is None:
            glue_us += d
        else:
            fam_us[fam] = fam_us.get(fam, 0.0) + d
        key = fam if fam is not None else e["name"][:80]
        op_us[key] = op_us.get(key, 0.0) + d
    busy = _union(spans)
    busy_us = sum(hi - lo for lo, hi in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("name") in HOST_LABELS and e.get("cat") != "gpu_user_annotation")
    host_starts = [lo for lo, _, _ in host]
    # idle gaps inside the window, each named by the host range at its middle
    gaps = {}
    edges = [(w0, w0)] + [tuple(b) for b in busy] + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(host_starts, mid) - 1
        label = host[i][2] if i >= 0 and host[i][1] >= mid else "host between ranges"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "family_s": {k: v * 1e-6 for k, v in fam_us.items()},
        "glue_s": glue_us * 1e-6,
        "device_ops": [[k, v * 1e-6] for k, v in
                       sorted(op_us.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v * 1e-6] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def read_profile(prof, families: dict, folder: str) -> dict:
    """Export the profiler's trace into `folder`, reduce it, delete it."""
    os.makedirs(folder, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=folder)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)
    return reduce(events, families)
