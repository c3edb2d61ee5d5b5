#!/usr/bin/env python3
"""Where a pass of kernel ntt_mxu spends its time, on one H100.

    python3 port_tools/ntt_mxu_variants.py

Builds csrc/ntt_mxu.cu as it is and in five variants made by patching its
text (into build/ntt_mxu_variants/, all at once), then times pass A (with
the twist) and pass B of the forward transform at tools/bench_ntt_mxu.py's
two shapes (batch 128 x 2, inputs from np.random.default_rng(0)) with CUDA
events, three rounds with the variants in turns:

- kernel: the source as committed (its output held to the plain version);
- no_epilogue: the fold adds the groups' partials without reducing them
  and the epilogue stores them without the twist (no Shoup product, no
  twist loads);
- mma_x3: every wgmma issued three times (the output is wrong; the extra
  time is two more passes' worth of tensor-core work);
- fold_x3: two more dependent Shoup products an output and group of
  planes in the fold;
- barrett128: the other exact reduction: the groups' partials summed into
  the 128-bit value offset + sum_g partial_g 2^(40 g) (the JAX package's
  ladder offset, tables.neg_offset) and reduced once by a 128-bit Barrett
  (tables.ratio0 / ratio1), instead of a Shoup product a group (its output
  held to the plain version too);
- cols16: 16 data columns a stage with W resident (wgmma m64n16k32 from
  shared memory; ops.ntt_mxu.ntt_mxu_layout at 16 columns), against the
  32 that ntt_mxu_geometry picks there (held to the plain version).

mma_x3 - kernel, halved, is what the digit-pair products alone cost when
nothing else hides them; fold_x3 - kernel, halved, one Shoup product an
output and group; kernel - no_epilogue what the fold's reductions and the
twist add.  Prints the card's name and power limit, each variant's
registers and stack frame (ptxas), then one JSON line per shape, pass and
variant with its three times.  Exits non-zero without a card or when a
variant that should be exact differs from the plain version.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# text patches: (anchor, replacement) pairs applied to csrc/ntt_mxu.cu
_WGMMA = ("                                wgmma_ss<NT>(acc[ii], alo, ((d * MT * KS + kg) * 2048) "
          ">> 4, ahw,\n")
_FOLD0 = "                    res[j] = mul_mod_shoup(u, 1, cst[C_ONE_S], p);\n"
_FOLDG = ("                    res[j] = add_mod(res[j],\n"
          "                                     mul_mod_shoup(u, cst[C_W + 2 * (g - 1)], "
          "cst[C_W + 2 * g - 1], p),\n"
          "                                     p);\n")
_PART = "                const u64 p = cst[C_P], u = (u64)part + cst[C_BIAS];\n"
_ACC = "        u64 res[OUT];\n"
_FOLDB = ("                const u64 p = cst[C_P], u = (u64)part + cst[C_BIAS];\n"
          "                if (g == 0)\n" + _FOLD0 + "                else\n" + _FOLDG)
_SS16 = """template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], unsigned alo, unsigned aoff,
                                              unsigned ahi, unsigned blo, unsigned boff,
                                              unsigned bhi, int accumulate) {
    asm volatile("{\\n.reg .pred p;\\n.reg .b32 alo, blo;\\n.reg .b64 da, db;\\n"
                 "add.u32 alo, %8, %9;\\n"
                 "mov.b64 da, {alo, %10};\\n"
                 "add.u32 blo, %11, %12;\\n"
                 "mov.b64 db, {blo, %13};\\n"
                 "setp.ne.b32 p, %14, 0;\\n"
                 "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, da, db, p;\\n}\\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7])
                 : "r"(alo), "r"(aoff), "r"(ahi), "r"(blo), "r"(boff), "r"(bhi),
                   "r"(accumulate));
}
"""
_SS32 = "template <>\n__device__ __forceinline__ void wgmma_ss<32>("
_RESCHECK = "    if (nt != (res ? 32 : 16) || "
_DISPATCH = "    if (!res) return launch<16, false, 4>(P, x, R, grid_x, smem, s);\n"
PATCHES = {
    "kernel": [],
    # the fold sums the groups' partials without a reduction, and no twist
    "no_epilogue": [(_FOLD0, "                    res[j] = u;\n"),
                    (_FOLDG, "                    res[j] += u;\n"),
                    ("        if (P.tw) {\n#pragma unroll\n            for (int j8",
                     "        if (false) {\n#pragma unroll\n            for (int j8"),
                    ("r[c2] = P.tw ? mul_mod_shoup(res[j], tv[j], ts[j], p) : res[j];",
                     "r[c2] = res[j];")],
    "mma_x3": [(_WGMMA, "                                for (int rep = 0; rep < 3; ++rep)\n"
                + _WGMMA)],
    # two more dependent Shoup products an output and group
    "fold_x3": [(_PART, "                const u64 p = cst[C_P];\n"
                 "                u64 u = (u64)part + cst[C_BIAS];\n"
                 "                for (int rep = 0; rep < 2; ++rep)\n"
                 "                    u = mul_mod_shoup(u, cst[C_W], cst[C_W + 1], p) + (u >> 62);\n")],
    # the 128-bit running sum (res the low words, rhi the high) from the
    # ladder offset, one Barrett reduction after the last group; the fold
    # constants are then the offset's words and floor(2^128 / p)'s low word
    "barrett128": [(_ACC, _ACC + "        u64 rhi[OUT];\n"),
                   (_FOLDB,
                    "                const u64 lo_add = g == 0 ? (u64)part : g == 1 ? (u64)part << 40 : 0;\n"
                    "                const u64 hi_add = g == 0   ? (u64)(part >> 63)\n"
                    "                                   : g == 1 ? (u64)(part >> 24)\n"
                    "                                            : (u64)part << 16;\n"
                    "                if (g == 0) {\n"
                    "                    res[j] = cst[C_BIAS];\n"
                    "                    rhi[j] = cst[C_W];\n"
                    "                }\n"
                    "                asm(\"add.cc.u64 %0, %0, %2;\\n\\taddc.u64 %1, %1, %3;\"\n"
                    "                    : \"+l\"(res[j]), \"+l\"(rhi[j]) : \"l\"(lo_add), \"l\"(hi_add));\n"
                    "                if (g == (S - 1) / G)\n"
                    "                    res[j] = barrett_reduce_128(rhi[j], res[j], cst[C_P], cst[C_W + 1],\n"
                    "                                                cst[C_ONE_S]);\n")],
    # 16 data columns a stage with W resident: the m64n16k32 shared-memory
    # form, the host's check and the dispatch opened to it
    "cols16": [(_SS32, _SS16 + _SS32),
               (_RESCHECK, "    if ((nt != 16 && nt != 32) || (!res && nt != 16) || "),
               (_DISPATCH, _DISPATCH + "    if (nt == 16)\n"
                "        return ks == 4 ? launch<16, true, 4>(P, x, R, grid_x, smem, s)\n"
                "                       : launch<16, true, 2>(P, x, R, grid_x, smem, s);\n")],
}
# the variants whose output is the kernel's (held to the plain version)
EXACT = ("kernel", "barrett128", "cols16")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ntt_mxu_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from gemini_seal_tpu_torch.modulus import CoeffModulus
    from gemini_seal_tpu_torch.ops import cuda
    from gemini_seal_tpu_torch.ops import ntt_mxu as mxu
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor
    from chip_smoke import event_ms

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
        # ptxas -v: each instantiation's stack frame and spills, by (NT, resident, KS)
        frames = {",".join(m[:3]): {"stack": int(m[3]), "spill_stores": int(m[4])}
                  for m in re.findall(r"ntt_mxu_kernelILi(\d+)ELb(\d)ELi(\d)E\S*\s+"
                                      r"(\d+) bytes stack frame, (\d+) bytes spill stores", err)}
        print(json.dumps({"variant": name, "frames": frames,
                          "registers": sorted({int(v) for v in re.findall(r"Used (\d+) registers", err)})}),
              flush=True)
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")).gst_ntt_mxu
        fn.argtypes = cuda.KERNELS["ntt_mxu"][2]
        fn.restype = ctypes.c_int
        funcs[name] = fn

    ok = True
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, bits in ((16384, [50, 40, 40, 40, 40, 50]), (8192, [50, 40, 40, 50])):
        mods = [m.value for m in CoeffModulus.create(n, bits)]
        tabs = mxu.build_mxu_ntt_tables(n.bit_length() - 1, mods, device=dev)
        L = len(mods)
        rng = np.random.default_rng(0)
        x = to_tensor(np.stack([rng.integers(0, p, (128, 2, n), dtype=np.uint64) for p in mods],
                               axis=2), dev).reshape(128, 2, L, tabs.n1, tabs.n2)
        R = x.numel() // n
        out = torch.empty_like(x)
        folds = {"barrett128": np.concatenate([
            tabs.neg_offset[:, 0].cpu().numpy(), tabs.neg_offset[:, 1].cpu().numpy(),
            tabs.ratio0.cpu().numpy(), np.zeros(2 * L, dtype=np.int64)]).view(np.uint64)}
        shoup_fold = mxu.fold_constants(mods)
        passes = {"A": (tabs.fwd_col, (tabs.fwd_twist, tabs.fwd_twist_shoup), tabs.n1, tabs.n2),
                  "B": (tabs.fwd_row, (None, None), tabs.n2, tabs.n1)}

        def launch(name, mode):
            w, (tw, tws), side, other = passes[mode]
            m = 0 if mode == "A" else 1
            geo = mxu.ntt_mxu_layout(16 if name == "cols16" else 32 if side <= 128 else 16,
                                     side, other, R, L, tabs.ndig_w, tabs.ndig_x, m, sms)
            geom = np.array([geo[f] for f in mxu.GEOM_FIELDS], dtype=np.int64)
            fold = folds.get(name, shoup_fold)
            args = [out.data_ptr(), x.data_ptr(), w.data_ptr(), cuda.ptr(tw), cuda.ptr(tws),
                    tabs.modulus.data_ptr(), tabs.ratio1.data_ptr(), fold.ctypes.data,
                    mxu._host_counts(w, tabs).ctypes.data, geom.ctypes.data, R, L, side, other,
                    m, tabs.ndig_w, tabs.ndig_x, stream]
            fn = funcs[name]

            def call(keep=(geom, fold)):   # the host arrays live as long as the call
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"{name}, pass {mode}: cudaError {rc}")
            return call

        for mode, (w, (tw, tws), side, other) in passes.items():
            with plain_versions():
                want = mxu.mxu_pass(x, w, tabs, mode, twist=None if tw is None else (tw, tws))
            calls = {name: launch(name, mode) for name in funcs}
            rows = {name: {"n": n, "pass": mode, "variant": name, "card": "see first line",
                           "ms": []} for name in funcs}
            for name in EXACT:
                calls[name]()
                torch.cuda.synchronize()
                rows[name]["equal_to_plain"] = bool(torch.equal(out, want))
                ok &= rows[name]["equal_to_plain"]
            for _ in range(3):
                for name, call in calls.items():
                    rows[name]["ms"].append(event_ms(torch, call, 20))
            for row in rows.values():
                print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
