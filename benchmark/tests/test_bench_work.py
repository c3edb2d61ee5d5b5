"""Each kernel family's work count on a known shape, and the capture of one
step's calls through the program's wrappers."""

import torch

from benchmark import capture, spec
from benchmark.tests.small import overrides


def _w(name):
    return spec.load_module("work", name)


def test_ntt_work():
    x = torch.zeros(2, 3, 1024, dtype=torch.int64)
    b, i = _w("ntt").work("ntt_forward", (x, None), {}, torch.empty_like(x))
    assert b == 8 * 2 * 6144
    assert i == 6 * 512 * 10 * 10


def test_contract_work_counts_only_the_rows_some_weight_keeps():
    a = torch.ones(1, 4, 3, 1024, dtype=torch.int64)       # broadcast over 2 groups
    w = torch.ones(2, 4, 3, 1024, dtype=torch.int64)
    out = torch.empty(2, 3, 1024, dtype=torch.int64)
    b, i = _w("contract").work("contract_mulmod_128", (a, w, None, None, None), {}, out)
    assert b == 8 * (a.numel() + w.numel() + out.numel())
    assert i == out.numel() * (4 * 7 + 24)
    w[:, 3] = 0
    b, i = _w("contract").work("contract_mulmod_128", (a, w, None, None, None), {}, out)
    assert b == 8 * ((a.numel() + w.numel()) * 3 // 4 + out.numel())
    assert i == out.numel() * (3 * 7 + 24)
    s = torch.ones(2, 4, dtype=torch.int64)
    b, i = _w("contract").work("contract_mulmod_128", (a, w, None, None, None),
                               {"prescale": (s, s, s, s)}, out)
    assert i == out.numel() * (3 * 7 + 24) + (a.numel() // 4) * 3 * 10 * 2


def test_galois_work_is_bytes_only():
    x = torch.zeros(3, 1024, dtype=torch.int64)
    b, i = _w("galois").work("galois_permute", (x, None), {},
                             torch.empty(2, 3, 1024, dtype=torch.int64))
    assert (b, i) == (8 * (3072 + 6144), 0)


def test_behz_work():
    x = torch.zeros(2, 5, 1024, dtype=torch.int64)
    out = torch.empty(2, 4, 1024, dtype=torch.int64)
    assert _w("behz").work("behz", ("sm_mrq", x, None), {}, out) == (
        8 * (x.numel() + out.numel()), 2048 * 3 + out.numel() * 20)
    assert _w("behz").work("behz", ("sk_tail", x, None, None), {}, out) == (
        8 * (x.numel() + 2048 + out.numel()), (out.numel() + 2048) * 10)


def test_capture_counts_one_step_and_puts_the_wrappers_back():
    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.models import pipelines
    from gemini_seal_tpu_torch.ops import keyswitch

    from benchmark import scheme

    cell = "ckks16k.mul_relin_rescale"
    bench = spec.load_benchmark()
    cfg = dict(spec.config(bench, "ckks_n16384_seal_default"), **overrides(cell)["config"])
    traffic = dict(spec.traffic("mul_relin_rescale_b128"), **overrides(cell)["traffic"])
    step = spec.load_module("steps", traffic["op"])
    d = scheme.draw(5, cfg, traffic, 2)
    ctx = scheme.context(T, cfg, "cpu")
    sk = scheme.secret_key(cfg, d["secret"])
    keys = step.keys(T, ctx, scheme.keygen(T, ctx, sk, "cpu"), traffic)
    a = scheme.encrypt(cfg, d, sk, "cpu")[0]
    fn = step.build(T, ctx, traffic, keys)
    before = (pipelines.ntt_forward, keyswitch.contract_mulmod_128)
    mods = {f: _w(f) for f in ("ntt", "contract", "galois", "behz")}
    calls = capture.step_work(lambda: fn(a, a), mods)
    assert calls["ntt"] and calls["contract"]
    assert not calls["galois"] and not calls["behz"]
    assert (pipelines.ntt_forward, keyswitch.contract_mulmod_128) == before
    peaks = {"hbm_bytes_per_s": 1.0, "int32_imad_per_s": 1e30}
    assert capture.bound_s(calls["ntt"], peaks) == sum(b for b, _ in calls["ntt"])
