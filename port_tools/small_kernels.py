#!/usr/bin/env python3
"""The small, launch-bound kernels timed at their callers' shapes: mod_raise
(K8), negacyclic (K9) and infty_norm (K10), with elementwise reduce64 (K4)
as a control.

    python3 port_tools/small_kernels.py [--repo DIR] [--sweep]

K8 at bench_all.py's N=4096 refresh (plan_bootstrap_chain(4096, radix=4,
nsp=3, restored=2): [2, 1, 4096] -> [2, 21, 4096]), at batch 4 of it
([8, 1, 4096]), at the same plan's N=8192 chain ([2, 1, 8192] -> 21
primes) and at N=65536 with 64 primes, the most a launch takes (q0 of 59
bits, 63 of 50).  K9 at ex1's ring (bfv_default(4096)'s first two primes,
[2, 2, 4096]): mono_mul by the scalar 4 at x^0 (ex1's multiply_plain by
"4"), by a per-limb coefficient p - 1 and 2p - 1, and the shift by N + 3;
at ex3's ring (N=8192, CoeffModulus.create(8192, [50, 30, 30, 50, 50]),
[2, 5, 8192]): mono_mul by 4 at x^(N+3) and the shift by N + 3.  K10 on
ex1's shape and on bench.py's [128, 2, 4, 8192] (the fused step's
ciphertext batch, CoeffModulus.create(8192, [50, 40, 40, 50]): 67 MB, a
bytes-bound call); K4 reduce64 on ex1's shape.  Inputs from
np.random.default_rng(0) below their moduli, with K8's boundary residues
0, q0/2, q0/2 + 1 and q0 - 1 planted.

Each call is held to its plain version on the card (max_abs_err) and
timed with CUDA events as chip_smoke.py times its kernels
(chip_smoke.event_ms: 20 launches behind a device-side sleep), three times,
the calls in turn round by round, and the plain version once; beside it
the launch floor, an empty
kernel (gst_empty_launch) at the call's own grid (CTAs x threads), and for
a call launched in clusters an empty kernel in the same clusters
(gst_empty_cluster_launch of this checkout's csrc/infty_norm.cu, built
into build/small_kernels/).  The grid is the one the timed tree launches:
its host geometry (ops/modraise.py mod_raise_geometry, ops/dyadic.py
negacyclic_geometry, infty_norm_geometry) where it has one, else the grid
of 256-thread CTAs, one thread an input or output coefficient, that K8 and
K9 launched before them (K10: a CTA of 256 a row in the trees before its
cluster geometry; K4: the grid of csrc/elementwise.cu).

--repo DIR imports the port from another checkout (a parent tree unpacked
with git archive), whose wrappers take the same arguments: run this script
once per tree in one call to compare two trees on one card.
--mxu also times K12 ntt_mxu's transforms (ops/ntt_mxu.py, two launches
each) at tools/bench_ntt_mxu.py's two shapes (N=16384 on [50, 40, 40, 40,
40, 50] and N=8192 on [50, 40, 40, 50], batch 128 x 2, inputs from
default_rng(0)), forward and inverse, each held to K1's transform (and
through it to the plain version, which the card tests hold K1 to) and
timed like the calls above beside K1's, one JSON line a shape and
direction, with the least time of its int8 MACs at each limb's own digit
pairs and at the tables' (989.5e12 MACs/s) and of its bytes.
--sweep also times K8's, K9's and K10's geometry alternatives at each shape
(K8: 64-256 threads a CTA, 1 to L limbs a thread; K9: 64-256 threads a CTA;
K10 at ex1's shape: 128 or 256 threads, a row over 1, 2, 4 or 8 CTAs), a
shape's alternatives on the same
inputs in turn, three rounds of 50 launches, one JSON line each; the tree
must have the geometry functions.

Prints the card's name and power limit, then one JSON line per call.  Exits
non-zero without a card or when a kernel's output differs from its plain
version.
"""

import argparse
import itertools
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
REPS = 20
SWEEP_REPS = 50


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="time K8's, K9's and K10's geometry alternatives too")
    ap.add_argument("--mxu", action="store_true",
                    help="time K12's four-step transforms against K1 too")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.repo))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("small_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.ops import cuda, dyadic, modraise
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor
    from gemini_seal_tpu_torch.ops.dyadic import LimbConstants

    sys.path.remove(os.path.abspath(args.repo))
    from chip_smoke import event_ms, launch_floor, launch_floor_cluster, nvidia_smi_line

    card = nvidia_smi_line()
    print(card, flush=True)
    print(json.dumps({"repo": os.path.abspath(args.repo), "package": T.__file__,
                      "sweep": args.sweep}), flush=True)
    report = cuda.build()
    floor_lib = report["scale_round"]["path"]
    # the cluster launch floor comes from this checkout's K10 source, which
    # the timed tree (--repo) may not have
    cluster_lib = os.path.join(HERE, "build", "small_kernels", "empty_cluster.so")
    os.makedirs(os.path.dirname(cluster_lib), exist_ok=True)
    import subprocess
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", cluster_lib,
                    os.path.join(HERE, "gemini_seal_tpu_torch", "csrc", "infty_norm.cu")],
                   check=True, capture_output=True, timeout=600)
    rng = np.random.default_rng(0)
    dev = "cuda"
    has_geometry = hasattr(modraise, "mod_raise_geometry")
    if args.sweep and not has_geometry:
        print("small_kernels: --sweep needs a tree with the geometry functions",
              file=sys.stderr)
        return 1

    def res(mods, lead, n):
        return to_tensor(np.stack([rng.integers(0, p, size=lead + (n,), dtype=np.uint64)
                                   for p in mods], axis=len(lead)), dev)

    def old_grid(total):  # one thread an element, CTAs of 256, at most 32 an SM
        return min(-(-total // 256), 132 * 32), 256

    # ---- K8 shapes
    from gemini_seal_tpu_torch.models.bootstrap import plan_bootstrap_chain

    def chain(n, bits):
        return [m.value for m in T.CoeffModulus.create(n, bits)]

    b4096 = plan_bootstrap_chain(4096, radix=4, nsp=3, restored=2)[0]
    b8192 = plan_bootstrap_chain(8192, radix=4, nsp=3, restored=2)[0]
    k8_shapes = [
        ("refresh n4096", (2,), 4096, chain(4096, b4096)[:len(b4096) - 3]),
        ("refresh n4096 batch 4", (8,), 4096, chain(4096, b4096)[:len(b4096) - 3]),
        ("refresh n8192", (2,), 8192, chain(8192, b8192)[:len(b8192) - 3]),
        ("n65536 L=64", (2,), 65536, chain(65536, [59] + [50] * 63)),
    ]

    def k8_case(label, lead, n, mods):
        q0 = mods[0]
        mvals = [T.Modulus(p) for p in mods]
        p, r1, qm = (to_tensor(np.array([f(m) for m in mvals], dtype=np.uint64), dev)
                     for f in (lambda m: m.value, lambda m: m.const_ratio[1],
                               lambda m: q0 % m.value))
        c = rng.integers(0, q0, size=lead + (1, n), dtype=np.uint64)
        flat = c.reshape(-1)
        flat[:4] = [0, q0 >> 1, (q0 >> 1) + 1, q0 - 1]
        x = to_tensor(c, dev)
        fn = lambda: modraise.mod_raise_lift(x, p, r1, qm, q0 >> 1)  # noqa: E731
        B, L = x.numel() // n, len(mods)
        if has_geometry:
            geo = modraise.mod_raise_geometry(B, L, n)
            grid = ((B << geo["log_tiles"]) * geo["groups"], geo["threads"])
        else:
            geo, grid = None, old_grid(B * n)
        return {"kernel": "mod_raise", "label": label, "shape": [list(x.shape), [B, L, n]],
                "geometry": geo, "grid": grid}, fn

    # ---- K9 shapes
    def k9_ring(mods):
        return LimbConstants.from_moduli(mods, dev), mods

    ex1 = k9_ring([m.value for m in T.CoeffModulus.bfv_default(4096)][:2])
    ex3 = k9_ring(chain(8192, [50, 30, 30, 50, 50]))

    def col(mods, f):
        return to_tensor(np.array([f(p) for p in mods], dtype=np.uint64).reshape(-1, 1), dev)

    k9_shapes = [
        ("ex1 mono_mul 4", ex1, 4096, "mono", 4, 0),
        ("ex1 mono_mul per-limb p - 1", ex1, 4096, "mono", lambda p: p - 1, 0),
        ("ex1 mono_mul per-limb 2p - 1", ex1, 4096, "mono", lambda p: 2 * p - 1, 0),
        ("ex1 shift N + 3", ex1, 4096, "shift", None, 4096 + 3),
        ("ex3 mono_mul 4 x^(N+3)", ex3, 8192, "mono", 4, 8192 + 3),
        ("ex3 shift N + 3", ex3, 8192, "shift", None, 8192 + 3),
    ]

    def k9_case(label, ring, n, mode, coeff, k):
        limbs, mods = ring
        a = res(mods, (2,), n)
        if callable(coeff):
            coeff = col(mods, coeff)
        if mode == "shift":
            fn = lambda: dyadic.negacyclic_shift_poly(a, k, limbs)  # noqa: E731
        else:
            fn = lambda: dyadic.negacyclic_mono_mul_poly(a, coeff, k, limbs)  # noqa: E731
        R, L = 2, len(mods)
        if has_geometry:
            geo = dyadic.negacyclic_geometry(n)
            grid = ((R << geo["log_tiles"]) * L, geo["threads"])
        else:
            geo, grid = None, old_grid(a.numel())
        return {"kernel": "negacyclic", "label": label, "shape": list(a.shape), "k": k,
                "coefficient": ("per-limb" if torch.is_tensor(coeff) else coeff),
                "geometry": geo, "grid": grid}, fn

    # ---- K10 on ex1's shape and bench.py's batch
    bench = k9_ring(chain(8192, [50, 40, 40, 50]))

    def k10_cases():
        for label, (limbs, mods), lead, n in (("ex1 infty_norm", ex1, (2,), 4096),
                                              ("bench.py infty_norm", bench, (128, 2), 8192)):
            a = res(mods, lead, n)
            R, L = a.numel() // (len(mods) * n), len(mods)
            if hasattr(dyadic, "infty_norm_geometry"):
                geo = dyadic.infty_norm_geometry(n, R * L)
                grid = ((R << geo["log_tiles"]) * L, geo["threads"], 1 << geo["log_tiles"])
            else:
                geo, grid = None, (R * L, 256, 1)
            yield ({"kernel": "infty_norm", "label": label, "shape": list(a.shape),
                    "geometry": geo, "grid": grid},
                   lambda a=a, limbs=limbs: dyadic.poly_infty_norm(a, limbs))

    # ---- control on ex1's shape
    def control_cases():
        limbs, mods = ex1
        a = res(mods, (2,), 4096)
        wide = a + res(mods, (2,), 4096)
        yield ({"kernel": "elementwise:reduce64", "label": "ex1 reduce64",
                "shape": list(a.shape), "grid": old_grid(a.numel())},
               lambda: dyadic.modulo_poly_coeffs(wide, limbs))

    ok = True

    def run(cases, reps):
        """Check each case against its plain version, time the cases in turn,
        ROUNDS times (so that a drift of the card's clock touches them all
        alike), then each one's launch floor; one JSON line a case."""
        nonlocal ok
        for row, fn in cases:
            got = fn()
            with plain_versions():
                want = fn()
                row["plain_ms"] = event_ms(torch, fn, 1)
            err = int((got - want).abs().max()) if got.numel() else 0
            ok &= err == 0 and got.shape == want.shape
            row.update({"max_abs_err": err, "ms": [], "reps": reps})
        for _ in range(ROUNDS):
            for row, fn in cases:
                row["ms"].append(event_ms(torch, fn, reps))
        for row, _ in cases:
            blocks, threads = row["grid"][:2]
            cluster = row["grid"][2] if len(row["grid"]) > 2 else 1
            if cluster > 1:
                floor = launch_floor_cluster(torch, cluster_lib, reps,
                                             ((blocks, threads, cluster),))
                floor_ms = floor[f"{blocks}x{threads}/{cluster}"]
            else:
                floor_ms = launch_floor(torch, cuda, floor_lib, reps,
                                        ((blocks, threads),))[f"{blocks}x{threads}"]
            row.update({"median_ms": statistics.median(row["ms"]), "floor_ms": floor_ms,
                        "card": card})
            print(json.dumps(row), flush=True)

    run([k8_case(*s) for s in k8_shapes] + [k9_case(*s) for s in k9_shapes]
        + list(k10_cases()) + list(control_cases()), REPS)

    if args.mxu:
        from gemini_seal_tpu_torch.ops import ntt as ntt_ops
        from gemini_seal_tpu_torch.ops import ntt_mxu

        for n, bits in ((16384, [50, 40, 40, 40, 40, 50]), (8192, [50, 40, 40, 50])):
            mods = chain(n, bits)
            tabs = ntt_mxu.build_mxu_ntt_tables(n.bit_length() - 1, mods, device=dev)
            k1 = ntt_ops.build_ntt_tables(n.bit_length() - 1, mods).to(dev)
            xm = to_tensor(np.stack([np.random.default_rng(0).integers(0, p, (128, 2, n),
                                                                       dtype=np.uint64)
                                     for p in mods], axis=2), dev)
            rows_m = xm.numel() // n
            per_pair = (rows_m // len(mods)) * n * (tabs.n1 + tabs.n2)
            for d in ("forward", "inverse"):
                mxu_fn = getattr(ntt_mxu, f"ntt_{d}_mxu")
                k1_fn = getattr(ntt_ops, f"ntt_{d}")
                fns = {"mxu": lambda: mxu_fn(xm, tabs), "k1": lambda: k1_fn(xm, k1)}
                equal = bool(torch.equal(fns["mxu"](), fns["k1"]()))
                ok &= equal
                times = {k: [] for k in fns}
                for _ in range(ROUNDS):
                    for k, fn in fns.items():
                        times[k].append(event_ms(torch, fn, REPS))
                col = "fwd_col" if d == "forward" else "inv_col"
                pairs = {"per_limb": sum(a * b for a, b in zip(
                             getattr(tabs, "limb_ndig_w", {}).get(col, [tabs.ndig_w] * len(mods)),
                             getattr(tabs, "limb_ndig_x", [tabs.ndig_x] * len(mods)))),
                         "tables": tabs.ndig_w * tabs.ndig_x * len(mods)}
                print(json.dumps({
                    "kernel": "ntt_mxu", "label": f"n{n} {d}", "shape": list(xm.shape),
                    "equal_to_k1": equal, "ms": times["mxu"], "k1_ms": times["k1"],
                    "median_ms": statistics.median(times["mxu"]),
                    "k1_median_ms": statistics.median(times["k1"]),
                    "bound_ms": {k: per_pair * v / 989.5e12 * 1e3 for k, v in pairs.items()},
                    "bytes_bound_ms": 4 * xm.numel() * 8 / 3.35e12 * 1e3, "card": card}),
                    flush=True)

    if args.sweep:
        picked_k8, picked_k9 = modraise.mod_raise_geometry, dyadic.negacyclic_geometry

        def under(module, name, geo_fn, fn):
            def call():
                setattr(module, name, geo_fn)
                return fn()
            return call
        try:
            for shape in k8_shapes:
                row0, fn0 = k8_case(*shape)
                B, L, n = row0["shape"][1]
                alts = []
                for threads, lpt in itertools.product((64, 128, 256),
                                                      sorted({1, 2, 3, 4, 6, 7, 11, L})):
                    if lpt > L:
                        continue

                    def forced(B_, L_, N, threads=threads, lpt=lpt):
                        return {"threads": threads,
                                "log_tiles": (-(-N // threads) - 1).bit_length(), "lpt": lpt,
                                "groups": -(-L_ // lpt)}
                    geo = forced(B, L, n)
                    alts.append((dict(row0, label=row0["label"] + " (sweep)", geometry=geo,
                                      grid=((B << geo["log_tiles"]) * geo["groups"], threads)),
                                 under(modraise, "mod_raise_geometry", forced, fn0)))
                run(alts, SWEEP_REPS)
            modraise.mod_raise_geometry = picked_k8
            for shape in k9_shapes:
                row0, fn0 = k9_case(*shape)
                R, L, n = row0["shape"]
                alts = []
                for threads in (64, 128, 256):

                    def forced(N, threads=threads):
                        t = min(threads, max(32, 1 << (N - 1).bit_length()))
                        return {"threads": t, "log_tiles": (-(-N // t) - 1).bit_length()}
                    geo = forced(n)
                    alts.append((dict(row0, label=row0["label"] + " (sweep)", geometry=geo,
                                      grid=((R << geo["log_tiles"]) * L, geo["threads"])),
                                 under(dyadic, "negacyclic_geometry", forced, fn0)))
                run(alts, SWEEP_REPS)
            dyadic.negacyclic_geometry = picked_k9
            # K10 at ex1's shape: 128 or 256 threads, a row over 1 to 8 CTAs
            picked_k10 = dyadic.infty_norm_geometry
            try:
                row0, fn0 = next(iter(k10_cases()))
                R, L, n = row0["shape"]
                alts = []
                for threads, log_tiles in itertools.product((128, 256), range(4)):

                    def forced(N, rows=1, threads=threads, log_tiles=log_tiles):
                        return {"threads": threads, "log_tiles": log_tiles,
                                "iters": -(-N // (2 * threads << log_tiles))}
                    alts.append((dict(row0, label=row0["label"] + " (sweep)",
                                      geometry=forced(n),
                                      grid=((R << log_tiles) * L, threads, 1 << log_tiles)),
                                 under(dyadic, "infty_norm_geometry", forced, fn0)))
                run(alts, SWEEP_REPS)
            finally:
                dyadic.infty_norm_geometry = picked_k10
        finally:
            modraise.mod_raise_geometry, dyadic.negacyclic_geometry = picked_k8, picked_k9
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
