"""Runs one cell once: set-up, the measured window, the trace, the check.

Set-up draws the secret key and the messages from the seed, builds the
program's context and keys, encrypts the input batches (the benchmark's own
symmetric encryptions, scheme.encrypt) and warms the step on each of them.  The window is a closed loop that keeps
`in_flight` steps enqueued: the host enqueues step i + 1 while step i runs,
and a step's latency runs from the start of its enqueue to the moment the
host sees its completion event.  The loop cycles through the input batches.
After the window the reference decrypts and decodes every answer of the
outputs kept (one early step drawn from the seed and the last step of each
input batch) and compares them with the answers worked out from the
messages.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import capture, check, scheme, spec, trace

TRACE_SECONDS = 2.0
WARM_ROUNDS = 2


class _HostEvent:
    """The CPU's stand-in for a CUDA event: a CPU step is done on return."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def closed_loop(fn, inputs, seconds, in_flight, device, keep, first=0, label=None):
    """Steps first, first + 1, ... on inputs[i % len(inputs)], in_flight at a
    time, until a completion is seen `seconds` after the start.  The steps
    still in flight then are drained and not counted."""
    label = label or (lambda name: contextlib.nullcontext())
    clock = time.perf_counter
    pending = collections.deque()
    latency, enqueue_s = [], []
    nb = len(inputs)
    index = first

    def enqueue():
        nonlocal index
        with label("enqueue"):
            ts = clock()
            out = fn(*inputs[index % nb])
            ev = torch.cuda.Event() if device == "cuda" else _HostEvent()
            ev.record()
            enqueue_s.append(clock() - ts)
        pending.append((index, ts, ev, out))
        index += 1

    t0 = clock()
    for _ in range(in_flight):
        enqueue()
    while True:
        j, ts, ev, out = pending.popleft()
        with label("wait"):
            ev.synchronize()
        tc = clock()
        latency.append(tc - ts)
        keep(j, out)
        if tc - t0 >= seconds:
            break
        enqueue()
    for _, _, ev, _ in pending:
        ev.synchronize()
    pending.clear()
    return {"steps": len(latency), "seconds": tc - t0, "latency_s": latency,
            "enqueue_s": enqueue_s, "enqueued": index - first, "next": index}


def _base_launches(cuda):
    return sum(v for k, v in cuda.LAUNCHES.items() if ":" not in k)


def _device_record(device, peak):
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def _power_limit():
    """The card's power limit in watts (nvidia-smi), or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float = None, overrides: dict = None, fault=None) -> dict:
    """One run of a cell; returns the result line's object.

    overrides: {"config": {...}, "traffic": {...}} laid over the cell's
    files (the tests' small rings); fault(fn, step, traffic) -> fn: a broken
    step put in the program's place (the tests of the check)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    cfg = dict(spec.config(bench, cell["config"]))
    traffic = dict(spec.traffic(cell["traffic"]))
    limits = spec.limits(cell_name)
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    step = spec.load_module("steps", traffic["op"])

    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.ops import cuda

    phases = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        cuda.build()
    phase("kernels")
    drawn = scheme.draw(seed, cfg, traffic, step.OPERANDS)
    msgs = drawn["messages"]
    sk_ntt = scheme.secret_key(cfg, drawn["secret"])
    phase("draw")
    ctx = scheme.context(T, cfg, device)
    phase("context")
    kg = scheme.keygen(T, ctx, sk_ntt, device)
    keys = step.keys(T, ctx, kg, traffic)
    del kg
    phase("keygen")
    k = step.OPERANDS
    cts = scheme.encrypt(cfg, drawn, sk_ntt, device)
    inputs = [tuple(cts[i * k:(i + 1) * k]) for i in range(traffic["input_batches"])]
    del cts
    phase("encrypt")
    fn = step.build(T, ctx, traffic, keys)
    if fault is not None:
        fn = fault(fn, step, traffic)
    for _ in range(WARM_ROUNDS):
        for args in inputs:
            fn(*args)
    phase("warm")
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    keygen_s = phases["keygen"]
    print("benchmark: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)

    nb = len(inputs)
    in_flight = traffic["in_flight"]
    kept = {}

    def keep(j, out):
        if j == drawn["early_step"]:
            kept["early"] = (j, out)
        kept[j % nb] = (j, out)

    launches0 = _base_launches(cuda)
    trace_red = {}
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace.WINDOW):
            part = closed_loop(fn, inputs, min(TRACE_SECONDS, seconds), in_flight, device, keep,
                               label=record_function)
            _sync(device)
        prof.stop()
        rest = closed_loop(fn, inputs, max(seconds - TRACE_SECONDS, 0.0), in_flight, device,
                           keep, first=part["next"])
        loops = [part, rest]
    else:
        part = rest = closed_loop(fn, inputs, seconds, in_flight, device, keep)
        loops = [part]
    enqueued = sum(lp["enqueued"] for lp in loops)
    launches_per_step = (_base_launches(cuda) - launches0) / enqueued
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    work = {}
    if traced:
        families = spec.kernel_families()
        folder = os.path.join(spec.ROOT, "build", "benchmark_traces")
        trace_red = trace.read_profile(prof, families, folder) if device == "cuda" else {}
        del prof
        work_modules = {fam: spec.load_module("work", fam) for fam in families
                        if os.path.exists(os.path.join(spec.HERE, "work", f"{fam}.py"))}

        def one_step():
            fn(*inputs[0])
            _sync(device)

        work = capture.step_work(one_step, work_modules)

    # the program's state goes before the reference runs
    del inputs, keys, fn, ctx
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    values, failed, unchecked = {}, 0, 0
    primes, scale = step.level(cfg)
    seen = set()
    for j, out in kept.values():
        if j in seen:
            continue
        seen.add(j)
        want = torch.as_tensor(step.expected(msgs[j % nb], traffic, cfg))
        try:
            items = step.outputs(out)
            got = check.answers(items, sk_ntt, cfg, primes, scale)
        except (RuntimeError, ValueError, IndexError) as exc:
            print(f"benchmark: output of step {j} cannot be decrypted: {exc}",
                  file=sys.stderr)
            unchecked += want.shape[0]
            continue
        m = min(got.shape[0], want.shape[0])
        unchecked += want.shape[0] - m
        nums, bad = check.numbers(cfg["scheme"], got[:m], want[:m], limits)
        values = check.merge(values, nums)
        failed += bad
    values["unchecked"] = unchecked
    correct, checks = check.judge(values, limits)

    ops = step.ops_per_step(traffic)
    steps_done = sum(lp["steps"] for lp in loops)
    result = {"correct": bool(correct), "attempted": steps_done * ops, "failed": failed + unchecked}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not traced:
        e2e = {
            "ops_per_s": part["steps"] * ops / part["seconds"],
            "batch_p95_ms": float(np.percentile(part["latency_s"], 95)) * 1e3,
            "setup_s": setup_s,
        }
        for m in spec.metrics_for(bench, "end_to_end", cell_name):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        host = rest if rest["steps"] > 1 else part
        obs = SimpleNamespace(
            cell=cell_name, cfg=cfg, traffic=traffic, device=device,
            device_name=torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            keygen_s=keygen_s, setup_s=setup_s, enqueue_s=host["enqueue_s"],
            launches_per_step=launches_per_step, trace=trace_red,
            traced_steps=part["enqueued"], work=work, memory_peak_bytes=peak)
        for m in spec.metrics_for(bench, "per_layer", cell_name):
            value = spec.load_module("metrics", m["name"]).read(obs)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = _device_record(device, peak)
    if traced:
        if trace_red:
            result["device"]["busy_s"] = trace_red["busy_s"]
            result["device"]["window_s"] = trace_red["window_s"]
            result["breakdown"] = {"device_ops": trace_red["device_ops"],
                                   "idle_gaps": trace_red["idle_gaps"]}
        if device == "cuda":
            result["device"]["power_limit_w"] = _power_limit()
    result["checks"] = checks
    return result
