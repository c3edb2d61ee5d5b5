"""Finds the benchmark's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each lives in a file of its
own under this folder, as does each per-layer metric's reader, each kernel
family's work count and name list, and each cell's comparison limits:

  configs/<config>.json      the deployment's parameters, as run
  traffic/<mix>.json         the mix: its operation, batch, messages, checks
  steps/<op>.py              the operation a mix names
  metrics/<metric>.py        a per-layer metric's reader
  work/<family>.py           a kernel family's bytes and multiplies a call
  kernels/<family>.txt       the family's kernel function names
  limits/<cell>.json         the cell's comparison limits and their readings

Nothing here needs an edit when a cell, configuration, mix or metric is
added: each is found by its name.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell: str) -> dict:
    return _json("limits", f"{cell}.json")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} module {name!r} ({path})")
    mod_name = f"benchmark_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_families() -> dict:
    """family -> its kernel function names (kernels/<family>.txt)."""
    out = {}
    folder = os.path.join(HERE, "kernels")
    for f in sorted(os.listdir(folder)):
        if f.endswith(".txt"):
            with open(os.path.join(folder, f)) as fh:
                out[f[:-4]] = tuple(l.strip() for l in fh if l.strip()
                                    and not l.startswith("#"))
    return out


def metrics_for(bench: dict, section: str, cell: str) -> list:
    """The metrics of a section ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads key, and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
