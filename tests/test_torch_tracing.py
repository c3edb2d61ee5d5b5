"""The port's spans (gemini_seal_tpu_torch/tracing.py) on the plain versions
at N=1024: off, a span records nothing and constructs no record_function,
reads no clock and records no event; under a CPU torch.profiler session a
step of each of the four benchmarked builders yields the stage spans of its
table (count, parent), each a ``user_annotation`` range of the exported
chrome trace inside the step's; outputs are bit-identical with tracing on
and off; a second session's record holds none of the first's; a span inside
a span of its name counts once; and the ranks of a ThreadGroup keep their
own stacks.  The card's test (stage device time inside the step's) is in
test_torch_gpu.py, which imports the builders from here.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch_helpers import one_torch_thread  # noqa: F401

import gemini_seal_tpu_torch as T
from gemini_seal_tpu_torch import tracing
from gemini_seal_tpu_torch.modulus import CoeffModulus
from gemini_seal_tpu_torch.ops import cuda
from gemini_seal_tpu_torch.parallel.comm import ThreadGroup, run_spmd

N = 1024
BUILDERS = ("ckks_mul_relin_rescale", "bfv_mul_relin", "ckks_rotate_many", "bfv_rotate_many")
ROT_STEPS = [1, 3]

# span -> count in one step of each builder (tracing.py's table)
STAGES = {
    "ckks_mul_relin_rescale": {"step.ckks_mul_relin_rescale": 1, "keyswitch.modup": 1,
                               "keyswitch.inner_product": 1, "keyswitch.moddown": 2,
                               "rns.rescale": 1},
    "bfv_mul_relin": {"step.bfv_mul_relin": 1, "keyswitch.modup": 1,
                      "keyswitch.inner_product": 1, "keyswitch.moddown": 2,
                      "behz.extend": 2, "behz.floor": 1},
    "ckks_rotate_many": {"step.rotate_many": 1, "keyswitch.modup": 1,
                         "keyswitch.inner_product": 1, "keyswitch.moddown": 2},
    "bfv_rotate_many": {"step.rotate_many": 1, "keyswitch.modup": 1,
                        "keyswitch.inner_product": 1, "keyswitch.moddown": 2},
}


def _context(scheme: str, device):
    parms = T.EncryptionParameters(T.SchemeType.CKKS if scheme == "ckks" else T.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    bits = [50, 40, 40, 50] if scheme == "ckks" else [44, 44, 44]
    parms.set_coeff_modulus(CoeffModulus.create(N, bits))
    if scheme == "bfv":
        parms.set_plain_modulus(786433)
    return T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)


def build(name: str, device="cpu", seed: int = 0):
    """(step, args) of one builder at N=1024 on `device`: a batch of two
    random ciphertexts (pairs for the multiplies) and keys made on the
    CPU."""
    scheme = name.split("_")[0]
    ctx, cpu_ctx = _context(scheme, device), _context(scheme, "cpu")
    kg = T.KeyGenerator(cpu_ctx, device="cpu")
    primes = [m.value for m in cpu_ctx.first_context_data().parms.coeff_modulus]
    rng = np.random.default_rng(seed)

    def ct():
        x = np.stack([rng.integers(0, p, size=(2, 2, N), dtype=np.uint64) for p in primes],
                     axis=-2)
        return torch.from_numpy(x.astype(np.int64)).to(device)

    if "rotate" in name:
        elts = cpu_ctx.first_context_data().galois_tool.get_elts_from_steps(ROT_STEPS)
        keys = kg.galois_keys(elts).stacked(*elts).to(device)
        make = T.build_ckks_rotate_many if scheme == "ckks" else T.build_bfv_rotate_many
        return make(ctx, ROT_STEPS, device=device), (ct(), keys)
    keys = kg.relin_keys().stacked(2).to(device)
    make = T.build_ckks_mul_relin_rescale if scheme == "ckks" else T.build_bfv_mul_relin
    return make(ctx, device=device), (ct(), ct(), keys)


@pytest.fixture(scope="module")
def steps():
    return {name: build(name) for name in BUILDERS}


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _profiled(fn, *args):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"a span off used time.{name}")


@pytest.mark.parametrize("name", BUILDERS)
def test_off_a_span_records_nothing_and_touches_nothing(steps, name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span off constructed a record_function or an event")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing, "time", _Untouchable())
    monkeypatch.setattr(tracing, "_event", refuse)
    assert not tracing.is_on()
    fn, args = steps[name]
    fn(*args)
    assert tracing.summary() == {}


@pytest.mark.parametrize("name", BUILDERS)
def test_profiled_step_yields_its_table_of_spans(steps, name):
    fn, args = steps[name]
    _profiled(fn, *args)
    rec = tracing.summary()
    assert {k: v["count"] for k, v in rec.items()} == STAGES[name]
    step = next(k for k in rec if k.startswith("step."))
    for k, v in rec.items():
        assert v["parents"] == ([] if k == step else [step]), k
        assert v["launches"] == 0                     # the plain versions launch nothing
        assert v["device_s"] == v["host_s"] > 0       # the CPU's device time is its host time
    stages = sum(v["host_s"] for k, v in rec.items() if k != step)
    assert stages <= rec[step]["host_s"]


@pytest.mark.parametrize("name", BUILDERS)
def test_chrome_trace_nests_each_span_in_the_step(steps, name, tmp_path):
    fn, args = steps[name]
    _, prof = _profiled(fn, *args)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    found = {}
    for e in events:
        found.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert {k: len(v) for k, v in found.items()} == STAGES[name]
    step = next(k for k in found if k.startswith("step."))
    (lo, hi), = found[step]
    for k, ranges in found.items():
        for a, b in ranges:
            assert lo <= a <= b <= hi, (k, a, b, lo, hi)


@pytest.mark.parametrize("name", BUILDERS)
def test_outputs_are_bit_identical_with_tracing_on_and_off(steps, name):
    fn, args = steps[name]
    off = fn(*args)
    profiled, _ = _profiled(fn, *args)
    tracing.enable()
    enabled = fn(*args)
    tracing.disable()
    assert tracing.summary()["keyswitch.modup"]["count"] == 1
    assert torch.equal(off, profiled) and torch.equal(off, enabled)


def test_a_second_session_holds_none_of_the_first(steps):
    """A session's record is read (summary(), as the benchmark's readers do)
    after the session; the next session starts a fresh one."""
    fn, args = steps["ckks_mul_relin_rescale"]
    _profiled(fn, *args)
    assert tracing.summary()["step.ckks_mul_relin_rescale"]["count"] == 1
    fn(*args)                                     # off between the sessions
    fn, args = steps["bfv_rotate_many"]
    _profiled(fn, *args)
    assert set(tracing.summary()) == set(STAGES["bfv_rotate_many"])
    tracing.enable()
    fn, args = steps["bfv_mul_relin"]
    fn(*args)
    tracing.disable()
    assert set(tracing.summary()) == set(STAGES["bfv_mul_relin"])
    _profiled(lambda: None)
    with tracing.span("session.three"):
        pass
    assert set(tracing.summary()) == set(STAGES["bfv_mul_relin"])   # off again: nothing new
    tracing.enable()
    with tracing.span("session.three"):
        pass
    assert set(tracing.summary()) == {"session.three"}


def test_a_span_inside_its_own_name_counts_once():
    outer = tracing.span("stage")

    @tracing.span("stage")
    def inner():
        with tracing.span("leaf"):
            pass

    tracing.enable()
    with outer:
        inner()
        with outer:
            pass
    inner()
    rec = tracing.summary()
    assert rec["stage"]["count"] == 2
    assert rec["leaf"]["count"] == 2 and rec["leaf"]["parents"] == ["stage"]


def test_a_span_counts_the_launches_made_inside_it(monkeypatch):
    def launch():
        cuda._ON_THREAD.n = cuda.thread_launches() + 1

    tracing.enable()
    with tracing.span("outer"):
        launch()
        with tracing.span("inner"):
            launch()
            launch()
    rec = tracing.summary()
    assert rec["outer"]["launches"] == 3 and rec["inner"]["launches"] == 2


def test_the_ranks_of_a_thread_group_keep_their_own_spans():
    """Both ranks are inside "rank.outer" at once (a barrier), so a shared
    stack would count the second as nested in the first; each rank's inner
    span and exchange have that rank's outer span as parent."""
    team = ThreadGroup(2, "cpu", timeout=60)
    both_in = threading.Barrier(2, timeout=60)

    def body(g):
        with tracing.span("rank.outer"):
            both_in.wait()
            with tracing.span(f"rank{g.rank}.inner"):
                out = g.all_gather(torch.full((2,), g.rank, dtype=torch.int64), 0)
            both_in.wait()
        return out

    tracing.enable()
    outs = run_spmd(body, team)
    rec = tracing.summary()
    assert rec["rank.outer"]["count"] == 2
    assert rec["rank0.inner"]["parents"] == rec["rank1.inner"]["parents"] == ["rank.outer"]
    assert rec["gst_exchange"]["count"] == 2
    assert rec["gst_exchange"]["parents"] == ["rank0.inner", "rank1.inner"]
    assert all(torch.equal(o, torch.tensor([0, 0, 1, 1])) for o in outs)


def test_an_exchange_off_constructs_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an exchange off constructed a record_function")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    outs = run_spmd(lambda g: g.psum(torch.ones(2, dtype=torch.int64)),
                    ThreadGroup(2, "cpu", timeout=60))
    assert all(torch.equal(o, torch.full((2,), 2)) for o in outs)
    assert tracing.summary() == {}


def test_spans_from_many_threads_lose_no_update():
    """More threads than cores, switching every microsecond: every span's
    count and every thread's launches arrive, and no frame stays open."""
    import os
    import sys

    threads = 2 * len(os.sched_getaffinity(0))
    rounds = max(20, 3200 // threads)
    go = threading.Barrier(threads, timeout=60)

    def work():
        go.wait()
        for _ in range(rounds):
            with tracing.span("stress.outer"):
                cuda._ON_THREAD.n = cuda.thread_launches() + 1
                with tracing.span("stress.inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.enable()
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    rec = tracing.summary()
    assert rec["stress.outer"]["count"] == rec["stress.inner"]["count"] == threads * rounds
    assert rec["stress.outer"]["launches"] == threads * rounds
    assert rec["stress.inner"]["parents"] == ["stress.outer"]
    assert tracing._open_frames == 0
