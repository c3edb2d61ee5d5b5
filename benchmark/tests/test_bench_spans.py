"""The readers of the program's spans (metrics/*_ms.py over spans.py): None
on an empty record and on a program without spans; a traced run of each
small cell on the CPU reports exactly its span metrics, as floats; and of
two traced runs in one process the readers report the second's."""

import sys

import pytest

from benchmark import harness, spec
from benchmark.tests.small import CELLS, overrides

BENCH = spec.load_benchmark()
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]


def _reader(name):
    return spec.load_module("metrics", name).read


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_give_none_on_an_empty_record(name):
    from gemini_seal_tpu_torch import tracing

    tracing.reset()
    assert tracing.summary() == {}
    assert _reader(name)(None) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_give_none_without_the_programs_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "gemini_seal_tpu_torch.tracing", None)
    assert _reader(name)(None) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_cells_span_metrics(cell):
    r = harness.run(cell, 2 ** 31 + 17, 0.2, True, device="cpu", overrides=overrides(cell))
    assert r["correct"]
    want = {m["name"] for m in spec.metrics_for(BENCH, "per_layer", cell)
            if m["source"] == "program_span"}
    got = {k: v["value"] for k, v in r["metrics"].items() if k in SPAN_METRICS}
    assert set(got) == want
    assert all(isinstance(v, float) and v > 0 for v in got.values())
    step = got["step_device_ms"]
    stages = sum(v for k, v in got.items() if not k.startswith("step_"))
    assert stages <= step


def test_two_traced_runs_in_one_process_report_the_second():
    from gemini_seal_tpu_torch import tracing

    first, second = "ckks16k.mul_relin_rescale", "bfv8k.rotate_many8"
    harness.run(first, 5, 0.2, True, device="cpu", overrides=overrides(first))
    assert "rns.rescale" in tracing.summary()
    r = harness.run(second, 6, 0.2, True, device="cpu", overrides=overrides(second))
    rec = tracing.summary()
    assert set(rec) == {"step.rotate_many", "keyswitch.modup", "keyswitch.inner_product",
                        "keyswitch.moddown"}
    n = rec["step.rotate_many"]["count"]
    assert r["metrics"]["modup_ms"]["value"] == 1e3 * rec["keyswitch.modup"]["device_s"] / n
    assert "rescale_ms" not in r["metrics"]
    assert _reader("rescale_ms")(None) == 0.0          # a step span, and no rescale in it
