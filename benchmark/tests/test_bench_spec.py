"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every cell, configuration, mix, step, metric, work count and limit by its
name."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = 24  # the most cells later PRs may add, at this run length
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_entries_have_just_their_keys_and_valid_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        extra = {"workloads"}
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"}
        assert keys <= set(m) <= keys | extra
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_bounds_and_end_to_end_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces_and_reports_enough(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    step = spec.load_module("steps", traffic["op"])
    assert step.SCHEME == cfg["scheme"]
    assert spec.limits(cell)["numbers"]
    e2e = [m["name"] for m in spec.metrics_for(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_for(BENCH, "per_layer", cell)
    assert layer
    for m in layer:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            fam = m["name"][:-len("_roofline")]
            assert hasattr(spec.load_module("work", fam), "work")
            assert fam in spec.kernel_families()


def test_workload_keys_of_metrics_name_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_layers_are_named_in_perf_md():
    with open(os.path.join(spec.ROOT, "PERF.md")) as fh:
        perf = fh.read()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_configs_name_their_source_and_assumptions():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as fh:
            data = json.load(fh)
        assert data["source"] and data["assumed"] and data["guarantees"]
        assert len(data["coeff_modulus"]) == len(data["coeff_modulus_bits"])
        assert [p.bit_length() for p in data["coeff_modulus"]] == data["coeff_modulus_bits"]
