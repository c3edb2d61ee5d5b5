#!/usr/bin/env python3
"""Where a pass of kernel ntt_mxu spends its time, on one H100.

    python3 port_tools/ntt_mxu_variants.py

Builds csrc/ntt_mxu.cu as it is and in three variants made by patching its
text (into build/ntt_mxu_variants/), then times pass A (with the twist) and
pass B of the forward transform at tools/bench_ntt_mxu.py's two shapes
(batch 128 x 2, inputs from np.random.default_rng(0)) with CUDA events:

- kernel: the source as committed (its output held to the plain version);
- no_epilogue: the epilogue only sums the planes and stores the sum (no
  128-bit ladder, Barrett or twist);
- mma_x3: every digit-pair mma issued three times (the output is wrong;
  the extra time is two more passes' worth of tensor-core work);
- barrett_x3: two more Barrett reductions an output in the epilogue.

mma_x3 - kernel, halved, is what the digit-pair products alone cost when
nothing else hides them; barrett_x3 - kernel, halved, one Barrett an
output.  Prints one JSON line per shape and variant, the card's name and
power limit first.  Exits non-zero without a card.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# text patches: (anchor, replacement) pairs applied to csrc/ntt_mxu.cu
PATCHES = {
    "kernel": [],
    "no_epilogue": [("            long long part[4] = {0, 0, 0, 0};",
                     "            { long long sum = 0;\n"
                     "              for (int s = 0; s < S; ++s) sum += acc[s][i];\n"
                     "              if (ok[i]) orow[idx[i]] = sum; }\n"
                     "            continue;\n"
                     "            long long part[4] = {0, 0, 0, 0};")],
    "mma_x3": [("            for (int d = 0; d < DW; ++d) {\n"
                "                const unsigned char* pa",
                "            for (int rep = 0; rep < 3; ++rep)\n"
                "            for (int d = 0; d < DW; ++d) {\n"
                "                const unsigned char* pa")],
    "barrett_x3": [("            u64 r = barrett_reduce_128((u64)(v >> 64), (u64)v, p, r0, r1);",
                    "            u64 r = barrett_reduce_128((u64)(v >> 64), (u64)v, p, r0, r1);\n"
                    "            for (int rep = 0; rep < 2; ++rep)\n"
                    "                r = barrett_reduce_128((u64)(v >> 64) ^ r, (u64)v + r,\n"
                    "                                       p, r0, r1 ^ (r & 1));")],
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ntt_mxu_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from gemini_seal_tpu_torch.modulus import CoeffModulus
    from gemini_seal_tpu_torch.ops import cuda
    from gemini_seal_tpu_torch.ops import ntt_mxu as mxu
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "ntt_mxu_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "ntt_mxu.cu")) as fh:
        source = fh.read()
    procs = {}
    for name, patches in PATCHES.items():
        text = source
        for anchor, repl in patches:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}: the anchor is not in csrc/ntt_mxu.cu once")
            text = text.replace(anchor, repl)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(text.replace('#include "modops.cuh"',
                                  f'#include "{os.path.join(cuda.CSRC, "modops.cuh")}"'))
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    funcs = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")).gst_ntt_mxu
        fn.argtypes = cuda.KERNELS["ntt_mxu"][2]
        fn.restype = ctypes.c_int
        funcs[name] = fn

    def event_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.01 * 1.98e9))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n, bits in ((16384, [50, 40, 40, 40, 40, 50]), (8192, [50, 40, 40, 50])):
        mods = [m.value for m in CoeffModulus.create(n, bits)]
        tabs = mxu.build_mxu_ntt_tables(n.bit_length() - 1, mods, device=dev)
        rng = np.random.default_rng(0)
        x = to_tensor(np.stack([rng.integers(0, p, (128, 2, n), dtype=np.uint64) for p in mods],
                               axis=2), dev).reshape(128, 2, len(mods), tabs.n1, tabs.n2)
        out = torch.empty_like(x)
        passes = {"A": (tabs.fwd_col, (tabs.fwd_twist, tabs.fwd_twist_shoup), tabs.n1, tabs.n2),
                  "B": (tabs.fwd_row, (None, None), tabs.n2, tabs.n1)}
        for name, fn in funcs.items():
            row = {"n": n, "variant": name}
            for mode, (w, (tw, tws), side, other) in passes.items():
                args = [out.data_ptr(), x.data_ptr(), w.data_ptr(), cuda.ptr(tw), cuda.ptr(tws),
                        tabs.modulus.data_ptr(), tabs.ratio0.data_ptr(), tabs.ratio1.data_ptr(),
                        tabs.neg_offset.data_ptr(), x.numel() // n, len(mods), side, other,
                        0 if mode == "A" else 1, tabs.ndig_w, tabs.ndig_x, stream]
                rc = fn(*args)
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{name} pass {mode}: cudaError {rc}")
                if name == "kernel":
                    with plain_versions():
                        want = mxu.mxu_pass(x, w, tabs, mode,
                                            twist=None if tw is None else (tw, tws))
                    row[f"pass_{mode}_equal_to_plain"] = bool(torch.equal(out, want))
                row[f"pass_{mode}_ms"] = event_ms(lambda: fn(*args))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
