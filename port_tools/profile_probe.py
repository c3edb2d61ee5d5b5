#!/usr/bin/env python3
"""What torch.profiler costs chip_smoke.py at a path of many launches.

    python3 port_tools/profile_probe.py     # on a machine with an H100

Builds bench_all.py's d=16 attention cell (N=512, attention_plan(16)'s
chain, batch 16; about 600 kernel launches a step), times its keygen, then
profiles 10 steps four times, in turns with and without the profiler's
host (CPU) activity: the device ms a step each reads (the device-side
events only, as chip_smoke.py's profile_steps sums them), and the seconds
the profiled steps and ``key_averages()`` take.  One JSON line a run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch import tracing

    if not torch.cuda.is_available():
        print("profile_probe: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    d = 16
    levels, _, _ = T.attention_plan(d)
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(2 * d * d)
    parms.set_coeff_modulus(T.CoeffModulus.create(2 * d * d, [50] + [40] * levels + [50]))
    parms.set_random_seed(tuple(range(8)))
    ctx = T.SealContext(parms, sec_level=T.SecLevelType.none)
    kg = T.KeyGenerator(ctx)
    cod = T.CKKSEncoder(ctx)
    enc = T.Encryptor(ctx, kg.public_key())
    run, _, _, steps = T.build_ckks_attention(ctx, d, 2.0 ** 40, cod)
    t1 = time.perf_counter()
    elts = ctx.first_context_data().galois_tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts).stacked(*elts)
    rk = kg.relin_keys().stacked(2)
    torch.cuda.synchronize()
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "keygen_s": time.perf_counter() - t1,
                      "build_s": t1 - t0, "galois_keys": len(elts)}), flush=True)
    rng = np.random.default_rng(23)
    cts = [enc.encrypt(cod.encode(rng.uniform(-0.5, 0.5, d * d).tolist(), 2.0 ** 40)).data
           for _ in range(3)]
    qkv = [c.expand((16,) + tuple(c.shape)).contiguous() for c in cts]

    def fn():
        return run(*qkv, gk, rk)

    _, iters, dt = chip_smoke.steady(torch, fn, 16)
    for acts in (("cpu", "cuda"), ("cuda",), ("cpu", "cuda"), ("cuda",)):
        fn()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU if a == "cpu" else ProfilerActivity.CUDA
                                 for a in acts]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        spans = set(tracing.summary())   # the port's ranges, not kernels
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.key not in spans]
        print(json.dumps({"activities": acts, "step_ms": dt * 1e3 / iters,
                          "device_ms_per_step": sum(e.self_device_time_total for e in rows)
                          / 1e3 / 10,
                          "kernel_calls_per_step": sum(e.count for e in rows) / 10,
                          "profile_s": t3 - t2, "key_averages_s": time.perf_counter() - t3}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
