"""The result line's shape (a whole run at a small ring on the CPU), and
run.py's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.small import overrides

CELL = "ckks16k.rotate_many8"


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(traced):
    r = harness.run(CELL, 4242, 0.2, traced, device="cpu", overrides=overrides(CELL))
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert {"metrics", "device"} <= set(r)
    assert isinstance(r["correct"], bool)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    bench = spec.load_benchmark()
    section = "per_layer" if traced else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in spec.metrics_for(bench, section, CELL)}
    assert r["metrics"]
    for name, m in r["metrics"].items():
        assert allowed[name] == m["unit"] and isinstance(m["value"], float)
    if not traced:
        assert set(r["metrics"]) == set(allowed)
    json.dumps(r)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
