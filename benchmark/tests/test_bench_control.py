"""The control: the reference put in the program's place one precision step
below the configuration's (benchmark/control.py) must fail each cell's
limits.  On the CPU at a small ring; on the card (marked gpu) at each
cell's own sizes on three seeds, printing the readings that the limits in
limits/<cell>.json were set from."""

import pytest
import torch

from benchmark import check, control, scheme, spec
from benchmark.tests.small import CELLS, overrides

SEEDS = ((1 << 31) + 11, (1 << 31) + 12, (1 << 31) + 13)


def control_reading(cell, seed, small, device):
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = dict(spec.config(bench, w["config"]))
    traffic = dict(spec.traffic(w["traffic"]))
    if small:
        cfg.update(overrides(cell)["config"])
        traffic.update(overrides(cell)["traffic"])
    step = spec.load_module("steps", traffic["op"])
    msgs = scheme.draw(seed, cfg, traffic, step.OPERANDS)["messages"]
    limits = spec.limits(cell)
    values = {}
    for batch in msgs:
        m = torch.as_tensor(batch).to(device)
        want = torch.as_tensor(step.expected(m, traffic, cfg))
        nums, _ = check.numbers(cfg["scheme"], control.answers(step, m, traffic, cfg), want,
                                limits)
        values = check.merge(values, nums)
    values["unchecked"] = 0
    return values, limits


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_a_small_ring(cell):
    values, limits = control_reading(cell, SEEDS[0], True, "cpu")
    ok, checks = check.judge(values, limits)
    assert not ok, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        values, limits = control_reading(cell, seed, False, "cuda")
        ok, checks = check.judge(values, limits)
        print(f"control {cell} seed {seed}: {values}")
        assert not ok, checks
