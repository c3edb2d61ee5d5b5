#!/usr/bin/env python3
"""The two pre-scales of kernel contract, timed against each other on one H100.

    python3 port_tools/contract_prescale.py

ops.modops.contract_geometry picks, for a call with a pre-scale, a Shoup
multiply by constants that each CTA computes once (calls of more than two
waves of threads) or the Barrett mul_mod, which needs no set-up (smaller
calls).  This script forces each in turn at pre-scaled call shapes of the
paths of chip_smoke.py, from the largest (the fused step's and config 5's
mod-ups at batch 128) to the smallest (the refresh's base conversions and
the per-op API at batch 1), holds both outputs to the plain version, and
times each with CUDA events (chip_smoke.event_ms: the launches queued
behind a device-side sleep, so that a short call is timed on the device,
not at the host's launch rate), alternating the two five times.  Inputs
from np.random.default_rng(0): A below 2^50, weights below their 60-bit
moduli, pre-scale factors below their 50-bit moduli.

Prints the card's name and power limit, then one JSON line per shape
(its label, A and W shapes, the geometry's pick, its waves of threads,
the median ms of each pre-scale and which was faster), then a summary
line: on how many shapes the geometry's pick was the faster one.  Exits
non-zero without a card or when an output differs from the plain version.
"""

import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (label, A shape [..., Ga, K, Ja, N], W shape [G, K, J, 1]): pre-scaled
# contract calls of the paths, largest first
SHAPES = [
    ("cfg 5 mod-up", (128, 7, 1, 1, 32768), (7, 1, 8, 1)),
    ("cfg 4 mod-up", (128, 5, 1, 1, 16384), (5, 1, 6, 1)),
    ("BFV chain conversion", (3, 128, 1, 5, 1, 8192), (1, 5, 5, 1)),
    ("fused step mod-up", (128, 3, 1, 1, 8192), (3, 1, 4, 1)),
    ("cfg 5 mod-down dot", (128, 1, 1, 1, 32768), (1, 1, 7, 1)),
    ("fused step mod-down dot", (128, 1, 2, 1, 8192), (1, 2, 2, 1)),
    ("limb4 mod-up", (16, 4, 2, 1, 4096), (4, 2, 2, 1)),
    ("rotate-many mod-up", (16, 3, 1, 1, 8192), (3, 1, 4, 1)),
    ("device evaluator mod-up", (8, 3, 1, 1, 8192), (3, 1, 4, 1)),
    ("refresh conversion, 7 rows", (7, 3, 1, 4096), (7, 3, 23, 1)),
    ("refresh conversion, 5 rows", (5, 3, 1, 4096), (5, 3, 17, 1)),
    ("refresh conversion, 1 row", (1, 3, 1, 4096), (1, 3, 15, 1)),
    ("per-op mod-up", (3, 1, 1, 8192), (3, 1, 4, 1)),
    ("per-op dot", (1, 1, 1, 4096), (1, 1, 2, 1)),
]
ROUNDS = 5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("contract_prescale: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from gemini_seal_tpu_torch.modulus import Modulus
    from gemini_seal_tpu_torch.ops import modops as tm
    from gemini_seal_tpu_torch.ops.backend import to_tensor
    from gemini_seal_tpu_torch.utils.numth import get_primes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip(), flush=True)
    dev = torch.device("cuda")
    pick = tm.contract_geometry

    def consts(mods, shape):
        return tuple(to_tensor(np.array(v, dtype=np.uint64).reshape(shape), dev) for v in (
            mods, [Modulus(q).const_ratio[0] for q in mods],
            [Modulus(q).const_ratio[1] for q in mods]))

    rng = np.random.default_rng(0)
    right = 0
    try:
        for label, a_shape, w_shape in SHAPES:
            G, K, J, _ = w_shape
            N = a_shape[-1]
            R = int(np.prod(a_shape[:-4], dtype=np.int64))
            p, r0, r1 = consts(get_primes(1024, 60, J), (J,))
            qs = get_primes(1024, 50, G * K)
            pre = (to_tensor(rng.integers(0, 1 << 50, size=(G, K), dtype=np.uint64), dev),
                   *consts(qs, (G, K)))
            a = to_tensor(rng.integers(0, 1 << 50, size=a_shape, dtype=np.uint64), dev)
            w = to_tensor(rng.integers(0, 1 << 59, size=w_shape, dtype=np.uint64)
                          % np.array(get_primes(1024, 60, J), dtype=np.uint64).reshape(J, 1), dev)
            want = tm.contract_plain(a, w, p, r0, r1, pre)
            geo = pick(R, a_shape[-4], G, K, J, 1, N, 1, True, 2)
            times = {}
            for shoup in (False, True):
                tm.contract_geometry = (lambda *args, _s=shoup: pick(*args, shoup=_s))
                if not torch.equal(tm.contract_mulmod_128(a, w, p, r0, r1, pre), want):
                    print(f"contract_prescale: {label}: shoup={shoup} differs from the plain "
                          "version", file=sys.stderr)
                    return 1
                times[shoup] = []
            for _ in range(ROUNDS):
                for shoup in (False, True):
                    tm.contract_geometry = (lambda *args, _s=shoup: pick(*args, shoup=_s))
                    fn = lambda: tm.contract_mulmod_128(a, w, p, r0, r1, pre)  # noqa: E731
                    # about 1 ms of launches, and at most 50: their host time must
                    # stay inside event_ms's 10 ms device-side sleep
                    reps = max(5, min(50, int(1.0 / max(chip_smoke.event_ms(torch, fn, 3),
                                                        1e-3))))
                    times[shoup].append(chip_smoke.event_ms(torch, fn, reps))
            tm.contract_geometry = pick
            ms = {k: statistics.median(v) for k, v in times.items()}
            faster = "shoup" if ms[True] < ms[False] else "barrett"
            picked = "shoup" if geo["shoup"] else "barrett"
            right += faster == picked
            waves = R * geo["z_count"] * geo["tiles"] * geo["threads"] / tm._FILL
            print(json.dumps({"label": label, "a": a_shape, "w": w_shape, "pick": picked,
                              "waves": waves, "barrett_ms": ms[False], "shoup_ms": ms[True],
                              "faster": faster}), flush=True)
    finally:
        tm.contract_geometry = pick
    print(json.dumps({"shapes": len(SHAPES), "pick_was_faster": right}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
