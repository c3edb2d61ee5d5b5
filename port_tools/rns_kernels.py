#!/usr/bin/env python3
"""Kernels behz (K6) and scale_round (K7) timed at the paths' call shapes.

    python3 port_tools/rns_kernels.py [--repo DIR]

Builds a BFV context at each of three rings of chip_smoke.py's paths
(config 3: N=8192, CoeffModulus.create(8192, [50, 40, 40, 40, 50]);
config 1 and ex1: N=4096, bfv_default(4096); both with
PlainModulus.batching(N, 20), seed range(8)), makes each call's inputs from
np.random.default_rng(0) below their moduli, holds every output to the
plain version on the card bit for bit, and times each call with CUDA
events as chip_smoke.py times its kernels (chip_smoke.event_ms: 20
launches behind a device-side sleep), three times in turn, and the plain
version once.  The shapes are the steps' (sm_mrq and sk_tail at batch 128,
the config 3 BFV chain's and config 1's, and rank 0's of the five-gather
BEHZ schedule on config 3's ring, parallel/behz_sp.py) and the per-op API's
and the encryption's and decryption's (one ciphertext).

--repo DIR imports the port from another checkout (a parent tree unpacked
with git archive), whose wrappers take the same arguments: run this script
once per tree in one call to compare two trees on one card.
--shoup 0 or 1 makes every K6 call take its Barrett form or its Shoup
constants, whatever ops.rnsops.rns_geometry picks by the call's size, so
that the two forms can be timed against each other.

Prints the card's name and power limit, one JSON line per call shape (its
label, mode, input shape, the geometry where the tree picks one on the
host, the three ms and their median, the plain ms), then, where the tree's
scale_round library has the empty kernel, the launch floor line of
chip_smoke.py.  Exits non-zero without a card or when an output differs
from the plain version.
"""

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RINGS = {
    "cfg3": (8192, [50, 40, 40, 40, 50]),
    "cfg1": (4096, None),
}
# (label, ring, mode, leading dimensions of the input)
CALLS = [
    ("BFV chain sm_mrq", "cfg3", "sm_mrq", (128, 2)),
    ("BFV chain sk_tail", "cfg3", "sk_tail", (3, 128)),
    ("cfg 1 sm_mrq", "cfg1", "sm_mrq", (128, 2)),
    ("cfg 1 sk_tail", "cfg1", "sk_tail", (3, 128)),
    ("behz4 sm_mrq (rank 0)", "cfg3", "sm_mrq4", (128, 2)),
    ("behz4 sk_tail (rank 0)", "cfg3", "sk_tail4", (3, 128)),
    ("per-op n8192 sm_mrq", "cfg3", "sm_mrq", (2,)),
    ("per-op n8192 sk_tail", "cfg3", "sk_tail", (3,)),
    ("per-op n4096 sm_mrq", "cfg1", "sm_mrq", (2,)),
    ("per-op n4096 sk_tail", "cfg1", "sk_tail", (3,)),
    ("encrypt n8192 plain_add", "cfg3", "plain_add", ()),
    ("encrypt n8192 plain_sub", "cfg3", "plain_sub", ()),
    ("encrypt n4096 plain_add", "cfg1", "plain_add", ()),
    ("plain_add n8192 R=128", "cfg3", "plain_add", (128,)),
    ("decrypt n8192 t_gamma", "cfg3", "t_gamma", ()),
    ("decrypt n4096 t_gamma", "cfg1", "t_gamma", ()),
]
ROUNDS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--shoup", type=int, default=None, choices=(0, 1),
                    help="K6's Barrett form (0) or its Shoup constants (1) in every call")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.repo))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rns_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.ops import cuda, rnsops
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor

    sys.path.remove(os.path.abspath(args.repo))
    if args.shoup is not None:
        picked = rnsops.rns_geometry

        def rns_geometry(*a, **k):
            return dict(picked(*a, **k), shoup=args.shoup)
        rnsops.rns_geometry = rns_geometry
    from chip_smoke import event_ms, launch_floor, nvidia_smi_line

    card = nvidia_smi_line()
    print(card, flush=True)
    print(json.dumps({"repo": os.path.abspath(args.repo), "package": T.__file__,
                      "shoup": args.shoup}),
          flush=True)
    report = cuda.build()
    ctxs = {}
    for name, (n, bits) in RINGS.items():
        parms = T.EncryptionParameters(T.SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(T.CoeffModulus.create(n, bits) if bits
                                else T.CoeffModulus.bfv_default(n))
        parms.set_plain_modulus(T.PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = T.SealContext(parms, sec_level=T.SecLevelType.none, device="cuda")
        ctxs[name] = ctx.first_context_data()
    rng = np.random.default_rng(0)

    def res(mods, lead, n):
        return to_tensor(np.stack([rng.integers(0, p, size=lead + (n,), dtype=np.uint64)
                                   for p in mods], axis=len(lead)), "cuda")

    ok = True
    for label, ring, mode, lead in CALLS:
        cd = ctxs[ring]
        tool, n = cd.device_rns_tool, cd.parms.poly_modulus_degree
        host = tool.host
        if mode.endswith("4"):  # rank 0 of four's constants of the sharded BEHZ
            from gemini_seal_tpu_torch.parallel.behz_sp import _behz_consts

            mode, consts = mode[:-1], getattr(_behz_consts(cd, 4, 0), f"{mode[:-1]}_consts")
        elif mode in ("sm_mrq", "sk_tail"):
            consts = getattr(tool, f"{mode}_consts")
        if mode in ("sm_mrq", "sk_tail"):
            # the input limbs' moduli from the packed constants (layouts in csrc/behz.cu)
            k = [int(v) for v in consts.cpu().numpy().view(np.uint64)]
            L = (len(k) - 1) // 5 if mode == "sm_mrq" else (len(k) - 4) // 4
            last = 1 << 32 if mode == "sm_mrq" else k[4 * L]
            x = res(k[:L] + [last], lead, n)
        if mode == "sm_mrq":
            fn = lambda: rnsops.behz("sm_mrq", x, consts)  # noqa: E731
        elif mode == "sk_tail":
            aux = res([k[0], host.m_sk.value], lead, n)  # x_bsk: only its x_sk row is read
            fn = lambda: rnsops.behz("sk_tail", x, consts, aux=aux)  # noqa: E731
        elif mode == "t_gamma":
            x = res([host.t.value, host.gamma.value], lead, n)
            fn = lambda: rnsops.scale_round("t_gamma", x, tool.t_gamma_consts)  # noqa: E731
        else:
            x = res([q.value for q in cd.parms.coeff_modulus], lead, n)
            m = to_tensor(rng.integers(0, cd.parms.plain_modulus.value, size=n,
                                       dtype=np.uint64), "cuda")
            fn = lambda: rnsops.scale_round(mode, x, cd.plain_scaling_constants,  # noqa: E731
                                            plain=m)
        got = fn()
        with plain_versions():
            want = fn()
            plain_ms = event_ms(torch, fn, 1)
        equal = bool(torch.equal(got, want))
        ok &= equal
        times = [event_ms(torch, fn, 20) for _ in range(ROUNDS)]
        row = {"label": label, "mode": mode, "shape": list(x.shape), "equal": equal,
               "ms": times, "median_ms": statistics.median(times), "plain_ms": plain_ms,
               "card": card}
        if hasattr(rnsops, "rns_geometry"):
            rows, limbs = x.numel() // (x.shape[-2] * n), x.shape[-2]
            if mode in ("sm_mrq", "sk_tail"):
                geo = rnsops.rns_geometry(rows, limbs - 1, n, 2)
            elif mode == "t_gamma":
                geo = rnsops.rns_geometry(rows, 1, n, 2)
            else:
                geo = rnsops.rns_geometry(rows, limbs, n, 2, share_rows=True)
            row["geometry"] = geo
        print(json.dumps(row), flush=True)
    import ctypes

    if hasattr(ctypes.CDLL(report["scale_round"]["path"]), "gst_empty_launch"):
        print(json.dumps({"phase": "launch_floor", "card": card, "kernel": "empty_kernel",
                          "ms": launch_floor(torch, cuda, report["scale_round"]["path"], 20)}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
