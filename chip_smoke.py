#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # small rings on the CPU, plain versions

Ten paths run, each driven once with every launch counter set to 0 just
before it and read just after it.  Three are CKKS, on bench.py's ring
(N=8192, CoeffModulus.create(8192, [50, 40, 40, 50]), one special prime,
seed range(71, 79), scale 2^40):

- mul_relin_rescale (bench.py's step): keygen, encode of [1.001] * slots,
  public-key encrypt, broadcast to batch 128, the fused multiply +
  relinearize + rescale step, decrypt, decode (within 1e-4 of v^2);
- train_step (the flagship step of __graft_entry__.entry()): Galois keygen
  for step 1, encode of a seeded non-constant vector v, encrypt, batch 128,
  the sequential multiply + relinearize + rescale, rotate by one and add,
  decrypt, decode (within 1e-4 of v_i^2 + v_{i+1}^2);
- rotate_many (the hoisted rotations): Galois keygen for steps 1..8 and
  their counter-rotated stack, encrypt v, batch 16, eight rotations from
  one mod-up with each key form, decrypt, decode (each within 1e-4 of v
  shifted by its step; the two forms within 1e-5 of each other).

Two are BFV, on bench_all.py's rings with seed range(8) and
t = PlainModulus.batching(N, 20), each with keygen, BatchEncoder encode of
a seeded slot vector v in [0, t), public-key encrypt, batch 128, the step,
decrypt and decode (exactly v^2 mod t):

- bfv_mul_relin_chain (BASELINE config 3): N=8192,
  CoeffModulus.create(8192, [50, 40, 40, 40, 50]), SecLevelType.none; the
  BEHZ multiply + relinearize and the fused mod-switch to the last level;
- bfv_mul_relin (BASELINE config 1): N=4096, CoeffModulus.bfv_default(4096),
  SecLevelType.tc128; the BEHZ multiply + relinearize.

Five are the rest of bench_all.py's BASELINE configs and its N=65536 cell,
with its rings and seed range(8), nothing cut:

- bfv_rotate_rows (config 2): N=8192, bfv_default(8192), tc128, batch 128;
  apply_galois on both components (one signed ``galois`` launch), the
  power-basis switch_key of c1, add (bench_all.py:155-159), by one step;
  each row of the 2 x N/2 slot matrix decodes rotated by one, exactly;
- bfv_rotate_many (config 2'): the same ring, batch 16 x steps 1..8 from
  one mod-up, in both key forms; each step decodes exactly, and the
  counter-rotated form decodes equal to the default;
- ckks_mul_relin_rescale_n16384 (config 4): N=16384, [50, 40 x 4, 50],
  batch 128, the sequential step; decodes within 1e-4 of v^2;
- ckks_poly_eval_n32768 (config 5): N=32768, [59, 40 x 6, 59], scale
  2^40, batch 128, p(x) = 1 - x/2 + x^2/4 + x^3/8 + x^4/16 summed over 4
  adjacent slots ("flat" rotations, coeff_precision_bits 25), on a seeded
  non-constant v in [-1, 1]: each slot within 1e-3 of sum_{j<4} p(v_{i+j});
- n65536 (the SEAL cap): N=65536, [50, 40, 40, 50], the forward and
  inverse NTT of [16, 2, 4, 65536] random residues and the sequential
  multiply + relinearize + rescale at batch 16; decodes within 1e-4.

The script

1. prints the card (nvidia-smi name and power limit, torch and CUDA);
2. builds the seven kernels (nvcc, one process each, in parallel) and
   prints each one's -Xptxas -v summary;
3. drives the ten paths; as each kernel call happens it
4. holds every distinct kernel call (function, mode, shapes) against its
   plain PyTorch version on the same inputs on the card (bit-exact; the
   launches of the check are taken off the counters), and times each
   call of a path's step both ways with
   CUDA events beside the least time the card could take for the same
   work (and, for ``galois``, beside torch.index_select / torch.gather);
   ``scale_round``, which runs in encryption and decryption only, is timed
   at those calls; a kernel's modes (the large-ring NTT, the signed and
   paired Galois permutations, the broadcast contraction) are rows of
   their own;
5. checks batch 2 of every step form against the port's plain path on the
   card, bit for bit, and each one's decode (with BFV rotate_columns);
6. times each step at its full batch (ops/s or rotations/s, and the NTT
   rates of configs 4 and N=65536), the two key forms of each hoisted
   rotation in turns, and profiles each (device time by kernel, device
   busy share), with the recorder removed;
7. prints the kernels line and, last, the result line.

Any mismatch raises and the script exits non-zero; it exits non-zero with
no result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 3.35 TB/s; 32-bit integer
# multiply-adds at 64 lanes per SM (half the 128 FP32 lanes behind the
# 67 TFLOP/s FP32 rate): 132 SMs * 64 * 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_IMAD_PER_S = 132 * 64 * 1.98e9

# 32-bit IMADs per 64-bit operation (the reckoning PERF.md writes out):
# low word of a 64x64 product 3, high word (__umul64hi) 4, full 128-bit 7;
# Barrett mul_mod = full product 7 + barrett_reduce_128 24 = 31;
# Shoup lazy multiply = high 4 + two low words 6 = 10.
IMAD_MULMOD = 31
IMAD_BARRETT128 = 24
IMAD_SHOUP = 10
IMAD_MAC = 7
IMAD_BARRETT64 = 7
ELEMENTWISE_MULMODS = {"add": 0, "sub": 0, "neg": 0, "mul": 1, "muladd": 1,
                       "addmul": 1, "barrett64": 0, "submul": 1}

# the kernels (and kernel modes, "kernel:mode") each path's step must launch
PATH_KERNELS = {
    "mul_relin_rescale": ("ntt", "tensor_product", "contract", "elementwise"),
    "train_step": ("ntt", "tensor_product", "contract", "elementwise", "galois"),
    "rotate_many": ("ntt", "contract", "elementwise", "galois", "contract:broadcast",
                    "galois:paired"),
    "bfv_mul_relin_chain": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "bfv_mul_relin": ("ntt", "tensor_product", "contract", "elementwise", "behz"),
    "bfv_rotate_rows": ("ntt", "contract", "elementwise", "galois:signed"),
    "bfv_rotate_many": ("ntt", "contract", "elementwise", "galois", "galois:signed",
                        "contract:broadcast", "galois:signed_paired"),
    "ckks_mul_relin_rescale_n16384": ("ntt", "tensor_product", "contract", "elementwise"),
    "ckks_poly_eval_n32768": ("ntt:large_ring", "tensor_product", "contract",
                              "elementwise", "galois"),
    "n65536": ("ntt:large_ring", "tensor_product", "contract", "elementwise"),
}
# ... and the kernels each BFV path's encryption and decryption must launch
PHASE_KERNELS = {"encode_encrypt": ("scale_round",), "decrypt_decode": ("scale_round",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps every kernel wrapper wherever a module of the port holds it, so
    that each kernel call of a path, keygen through decode, is handed with
    its arguments and result to ``check`` (path, phase, label, kernel,
    function, args, kwargs, result) as it happens: the inputs need not be
    kept for a later replay, which at config 5's batch would not fit on the
    card.  The label is the kernel, or "kernel:mode" when the call counted
    a launch in one of the kernel's modes (cuda.MODES).  The launches that
    ``check`` makes are taken off the counters again.
    ``remove`` puts the wrappers back, so that later phases time the steps
    as a user calls them."""

    def __init__(self, check):
        from gemini_seal_tpu_torch.models import pipelines
        from gemini_seal_tpu_torch.ops import cuda, galois, modops, ntt, rnsops

        kernel_of = {ntt.ntt_forward_lazy: "ntt", ntt.ntt_forward: "ntt",
                     ntt.ntt_inverse_lazy: "ntt", ntt.ntt_inverse: "ntt",
                     pipelines._tensor_product: "tensor_product",
                     modops.contract_mulmod_128: "contract",
                     modops.rns_elementwise: "elementwise",
                     galois.galois_permute: "galois",
                     rnsops.behz: "behz",
                     rnsops.scale_round: "scale_round"}
        self.check = check
        self.launches = cuda.LAUNCHES
        self.path = None
        self.phase = None
        self._patched = []
        wrapped = {id(fn): (fn, self._wrap(kernel, fn)) for fn, kernel in kernel_of.items()}
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] != "gemini_seal_tpu_torch" or mod is None:
                continue
            for attr, value in list(vars(mod).items()):
                fn, wrapper = wrapped.get(id(value), (None, None))
                if fn is value:
                    setattr(mod, attr, wrapper)
                    self._patched.append((mod, attr, fn))

    def remove(self):
        for mod, attr, fn in self._patched:
            setattr(mod, attr, fn)
        self._patched = []

    def _wrap(self, kernel, fn):
        def wrapped(*args, **kwargs):
            before = dict(self.launches)
            out = fn(*args, **kwargs)
            if self.phase is not None:
                counts = dict(self.launches)
                label = next((k for k in counts if ":" in k and counts[k] > before[k]), kernel)
                self.check(self.path, self.phase, label, kernel, fn, args, kwargs, out)
                self.launches.update(counts)
            return out
        return wrapped


def by_label(launches):
    """Launch counts per kernel label: a kernel's own entry keeps only its
    calls outside its modes."""
    out = dict(launches)
    for key, count in launches.items():
        if ":" in key:
            out[key.split(":")[0]] -= count
    return out


def signature(args, kwargs):
    """What tells two calls of one wrapper apart: the op, the tensors'
    shapes and the table sizes."""
    def sig(v):
        if hasattr(v, "data_ptr"):
            return tuple(v.shape)
        if isinstance(v, (tuple, list)):
            return tuple(sig(x) for x in v)
        if hasattr(v, "coeff_count"):  # NTTTables
            return ("tables", v.coeff_count, v.modulus.numel())
        if hasattr(v, "ratio0"):  # LimbConstants
            return ("limbs", v.p.numel())
        return v
    return tuple(sig(v) for v in args) + tuple(sorted((k, sig(v)) for k, v in kwargs.items()))


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches.

    At least 10 ms of warm-up launches come first (a first call timed from
    an idle card ran up to 3x slow while its clock came up).  The timed
    launches are queued behind a 10 ms device-side sleep, so that they run
    back to back: a kernel shorter than its wrapper's host time would
    otherwise be timed at the host's launch rate."""
    warm_until = time.perf_counter() + 0.01
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < warm_until:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.01 * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_steps(torch, fn, steps: int, step_ms: float) -> dict:
    """Device time by kernel over `steps` steady steps (torch.profiler's
    device-side events only, so an operator and its kernel are not counted
    twice) and the device's busy share of the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = [{"name": e.key[:80], "calls_per_step": e.count / steps,
             "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    return {"steps": steps, "step_ms": step_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms, "by_kernel": rows}


def tensors_of(fn_name, args, kwargs):
    """The tensors a kernel call reads, the tables and constants included."""
    out = []
    for v in list(args) + list(kwargs.values()):
        if hasattr(v, "data_ptr"):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if hasattr(t, "data_ptr"))
        elif hasattr(v, "coeff_count"):  # NTTTables: the direction's twiddles
            if fn_name.startswith("ntt_inverse"):
                out += [v.inv_root_powers, v.scaled_inv_root_powers,
                        v.inv_degree_modulo, v.scaled_inv_degree]
            else:
                out += [v.root_powers, v.scaled_root_powers]
            out.append(v.modulus)
        elif hasattr(v, "ratio0"):  # LimbConstants
            out += [v.p, v.ratio0, v.ratio1]
    return out


def spans_of(t):
    """(start, end) byte spans of a tensor's elements: one span when it is
    contiguous, one per row (last axis, unit stride) for a view that picks
    rows out of a larger tensor."""
    es, ptr = t.element_size(), t.data_ptr()
    if t.is_contiguous():
        return [(ptr, ptr + t.numel() * es)]
    if t.stride(-1) != 1:
        raise ValueError("spans_of: last axis must have unit stride")
    offs = [0]
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        offs = [o + i * stride for o in offs for i in range(size)]
    row = t.shape[-1] * es
    return [(ptr + o * es, ptr + o * es + row) for o in offs]


def bytes_once(tensors) -> int:
    """Bytes of the union of the tensors' memory: a storage that two
    arguments share (the step squares by passing one ciphertext twice) is
    read once, and a view of some rows counts only those rows."""
    spans = sorted(sp for t in tensors if t.numel() for sp in spans_of(t))
    total, end = 0, 0
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def needed_inputs(kernel, args, kwargs):
    """The call's arguments with each input cut to the rows the function
    needs: a ``contract`` input row whose weights (or pre-scale) are all 0
    adds nothing to the sum (fastbconv_sk reads the whole Bsk tensor, its
    x_sk row at weight 0), and ``behz`` sk_tail needs only the x_sk row of
    its aux tensor.  Returns (args, kwargs, the contract's needed K)."""
    if kernel == "contract":
        a, w = args[0], args[1]
        live = w.ne(0).flatten(2).any(-1).any(0)  # w [G, K, J, Nw] -> [K]
        if kwargs.get("prescale") is not None:
            live &= kwargs["prescale"][0].ne(0).any(0)  # s [G, K]
        ks = [k for k in range(w.shape[1]) if bool(live[k])]
        if len(ks) < w.shape[1]:
            rows = [a.select(-3, k) for k in ks]  # a [..., G, K, Ja, N]
            return [rows] + list(args[1:]), kwargs, len(ks)
        return args, kwargs, len(ks)
    if kernel == "behz" and args[0] == "sk_tail":
        kw = dict(kwargs)
        if "aux" in kw:
            kw["aux"] = kw["aux"][..., -1:, :]
            return args, kw, None
        return list(args[:3]) + [args[3][..., -1:, :]] + list(args[4:]), kw, None
    return args, kwargs, None


def work(kernel, fn_name, args, kwargs, result):
    """(bytes, 32-bit IMADs) the call needs: every input read once, every
    output written once, and the integer multiplies of its arithmetic."""
    outs = result if isinstance(result, tuple) else (result,)
    need_args, need_kwargs, live_k = needed_inputs(kernel, args, kwargs)
    nbytes = bytes_once(tensors_of(fn_name, need_args, need_kwargs)) + bytes_once(outs)
    if kernel == "ntt":
        x, tables = args
        rows = x.numel() // x.shape[-1]
        n, log_n = tables.coeff_count, tables.coeff_count_power
        inverse = fn_name.startswith("ntt_inverse")
        ops = rows * (n // 2) * (log_n + (1 if inverse else 0)) * IMAD_SHOUP
    elif kernel == "tensor_product":
        a, b = args[0], args[1]
        ops = (a.numel() // 2) * (3 if b is None else 4) * IMAD_MULMOD
    elif kernel == "contract":
        a, w = args[0], args[1]
        K = w.shape[1]
        ops = outs[0].numel() * (live_k * IMAD_MAC + IMAD_BARRETT128)
        if kwargs.get("prescale") is not None:  # once per needed input element
            ops += a.numel() // K * live_k * IMAD_MULMOD
    elif kernel == "galois":
        ops = 0  # a permutation: bytes only
    elif kernel == "behz":
        # sm_mrq: low-word multiply for r, the 128-bit q*r, barrett_reduce_128
        # and a mul_mod per output; sk_tail: alpha once per coefficient and
        # one mul_mod per output (the selected branch)
        out = outs[0]
        if args[0] == "sm_mrq":
            ops = out.numel() * (3 + IMAD_MAC + IMAD_BARRETT128 + IMAD_MULMOD)
        else:
            ops = out.numel() * IMAD_MULMOD + (out.numel() // out.shape[-2]) * IMAD_MULMOD
    elif kernel == "scale_round":
        # plain modes: the fix once per coefficient (m * (q mod t) and the
        # divmod quotient), then Delta * m and barrett_reduce_128 per output;
        # t_gamma: three mul_mods and two barrett_reduce_64 per output
        out = outs[0]
        if args[0] == "t_gamma":
            ops = out.numel() * (3 * IMAD_MULMOD + 2 * IMAD_BARRETT64)
        else:
            ops = (out.shape[-1] + out.numel()) * (IMAD_MAC + IMAD_BARRETT128)
    else:
        ops = outs[0].numel() * ELEMENTWISE_MULMODS[args[0]] * IMAD_MULMOD
    return nbytes, ops


def library_call(torch, x, tabs, moduli=None, paired=False):
    """The one PyTorch call that computes galois_permute(x, tabs) (its
    permutation part in the signed modes, which no one call computes): an
    index_select over the last axis for one table, a gather of the
    broadcast rows for several, a gather of x's own rows when paired."""
    R, N = tabs.shape
    idx = tabs & (N - 1)
    if paired:
        pidx = idx.reshape(R, 1, N).expand(x.shape)
        return lambda: torch.gather(x, -1, pidx)
    if R == 1:
        return lambda: x.index_select(-1, idx[0])
    lead, rows = x.shape[:-2], x.shape[-2]
    shape = lead + (R, rows, N)
    src = x.unsqueeze(-3).expand(shape)
    gidx = idx.reshape(R, 1, N).expand(shape)
    return lambda: torch.gather(src, -1, gidx)


def steady(torch, fn, count: int):
    """(count per second, iterations, seconds) of fn over about 3 s."""
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per = time.perf_counter() - t1
    iters = max(5, min(200, int(3.0 / max(per, 1e-6))))
    t1 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    return count * iters / dt, iters, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the same phases at N=1024, batch 2, two rotations, "
                         "on the CPU through the plain versions (no result line)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import gemini_seal_tpu_torch as T
    from gemini_seal_tpu_torch.ops import cuda
    from gemini_seal_tpu_torch.ops import ntt as ntt_ops
    from gemini_seal_tpu_torch.ops.backend import plain_versions, to_tensor
    from gemini_seal_tpu_torch.utils import native

    rehearsal = args.cpu_rehearsal
    device = "cpu" if rehearsal else "cuda"
    n = 1024 if rehearsal else 8192
    batch = 2 if rehearsal else 128
    rot_batch = 2 if rehearsal else 16
    rot_steps = list(range(1, 3 if rehearsal else 9))
    reps = 1 if rehearsal else 20
    sync = torch.cuda.synchronize if not rehearsal else (lambda: None)

    # 1. the device ----------------------------------------------------------
    card = "cpu rehearsal"
    if not rehearsal:
        card = nvidia_smi_line()
        print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0) if not rehearsal else "cpu"})

    # 2. build ---------------------------------------------------------------
    if not rehearsal:
        t0 = time.perf_counter()
        report = cuda.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]}
                          for k, v in report.items()}})

    # 3. the ten paths, each once, with the counters from 0 ---------------------
    # (4. checks and times each kernel call as it happens: check_call)
    paths = {}
    phase_launches = {}
    mark = {}
    rows = {}
    seen = set()

    def check_call(path, phase, label, kernel, fn, cargs, ckw, result):
        """4. Every distinct (function, mode, shapes) call, keygen through
        decode, is run again through its plain version and compared with
        the kernel's result exactly; every call of a step is also timed both
        ways beside its bound (and galois beside its library call), and so
        is every call of scale_round, which runs outside the steps."""
        sync()
        row = rows.setdefault(label, {"checked": [], "step_calls": [], "by_path": {},
                                      "max_abs_err": 0, "tolerance": 0})
        key = (label, fn.__name__, signature(cargs, ckw))
        plain_s = None
        if key not in seen:
            seen.add(key)
            t1 = time.perf_counter()
            with plain_versions():
                got_p = fn(*cargs, **ckw)
            sync()
            plain_s = time.perf_counter() - t1
            pairs = zip(result, got_p) if isinstance(result, tuple) else [(result, got_p)]
            for x, y in pairs:
                # residues are compared exactly (tolerance 0): the u64 bit patterns
                row["max_abs_err"] = max(row["max_abs_err"], int((x - y).abs().max().item()))
                if not torch.equal(x, y):
                    raise AssertionError(f"{label} ({path} {phase}, {fn.__name__}): kernel "
                                         f"differs from its plain version at {tuple(x.shape)}")
            del got_p, pairs
            row["checked"].append({"path": path, "phase": phase, "fn": fn.__name__,
                                   "signature": repr(key[2])})
        if phase != "step" and kernel != "scale_round":
            return
        nbytes, ops = work(kernel, fn.__name__, cargs, ckw, result)
        ms = plain_ms = lib_ms = None
        if kernel == "galois":
            lib = library_call(torch, *cargs, **ckw)
            same = lib().reshape(result.shape) == result
            if (cargs[2] if len(cargs) > 2 else ckw.get("moduli")) is None:
                ok = bool(same.all())
            else:  # signed: the permutation part, equal wherever the result is 0
                ok = bool((same | result.ne(0)).all())
            del same
            if not ok:
                raise AssertionError(f"{label}: the library call differs from the kernel")
        if not rehearsal:
            ms = event_ms(torch, lambda: fn(*cargs, **ckw), reps)
            # a plain version slower than 20 ms is timed over one call
            plain_reps = 1 if plain_s is None or plain_s > 0.02 else max(2, reps // 4)
            with plain_versions():
                plain_ms = event_ms(torch, lambda: fn(*cargs, **ckw), plain_reps)
            if kernel == "galois":
                lib_ms = event_ms(torch, lib, reps)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_IMAD_PER_S) * 1e3
        row["step_calls"].append({"path": path, "fn": fn.__name__, "signature": repr(key[2]),
                                  "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                  "bound_ms": bound, "bytes": nbytes, "imads": ops})
        bp = row["by_path"].setdefault(path, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                              "bound_ms": 0.0, "bytes": 0, "imads": 0})
        if not rehearsal:
            bp["ms"] += ms
            bp["plain_ms"] += plain_ms
            bp["library_ms"] += lib_ms or 0.0
        bp["bound_ms"] += bound
        bp["bytes"] += nbytes
        bp["imads"] += ops

    recorder = Recorder(check_call)

    def set_phase(name):
        """Start phase `name` of the running path (None: the path is over);
        the launches of the phase that ends are kept under its name."""
        if recorder.phase is not None:
            phase_launches[recorder.phase] = {k: cuda.LAUNCHES[k] - mark[k] for k in mark}
        mark.clear()
        mark.update(cuda.LAUNCHES)
        recorder.phase = name

    def begin(path):
        recorder.path = path
        cuda.reset_launches()
        phase_launches.clear()
        if not rehearsal:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def end(path, t0, per_step, **extra):
        """per_step: the step's launches, or a list of them (one per form
        of a path that drives two)."""
        set_phase(None)
        sync()
        forms = per_step if isinstance(per_step, list) else [per_step]
        launches = by_label(cuda.LAUNCHES)
        paths[path] = {"launches": launches,
                       "launches_per_step": by_label(forms[0]),
                       "launches_by_phase": {ph: by_label(v) for ph, v in phase_launches.items()},
                       "seconds_with_checks": time.perf_counter() - t0,
                       "peak_device_bytes_with_checks": (None if rehearsal
                                                         else torch.cuda.max_memory_allocated()),
                       **extra}
        if len(forms) > 1:
            paths[path]["launches_per_step_by_form"] = [by_label(f) for f in forms]
        emit({"phase": "main_path", "path": path, **paths[path]})
        missing = [k for k in PATH_KERNELS[path]
                   if launches[k] == 0 or not any(by_label(f)[k] for f in forms)]
        if path.startswith("bfv"):
            missing += [f"{k} ({ph})" for ph, ks in PHASE_KERNELS.items() for k in ks
                        if phase_launches[ph][k] == 0]
        if not rehearsal and missing:
            raise AssertionError(f"kernels not launched on {path}: {missing}")

    def count_step(fn, *fargs):
        before = dict(cuda.LAUNCHES)
        out = fn(*fargs)
        return out, {k: cuda.LAUNCHES[k] - before[k] for k in cuda.LAUNCHES}

    def max_err(got, want):
        return max(abs(g - w) for g, w in zip(got, want))

    keygen_s = {}

    def keygen_done(path, t0):
        keygen_s[path] = time.perf_counter() - t0
        emit({"phase": "keygen", "path": path, "host_prng": "native g++ build"
              if native.available() else "pure python", "seconds": keygen_s[path]})

    # 3a. mul_relin_rescale: bench.py's fused step (as before this slice)
    t0 = begin("mul_relin_rescale")
    set_phase("keygen")
    parms = T.EncryptionParameters(T.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(T.CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    sec = T.SecLevelType.none if rehearsal else T.SecLevelType.tc128
    ctx = T.SealContext(parms, sec_level=sec, device=device)
    kg = T.KeyGenerator(ctx, device=device)
    pk = kg.public_key()
    rk = kg.relin_keys().stacked(2)
    keygen_done("mul_relin_rescale", t0)

    set_phase("encode_encrypt")
    encoder = T.CKKSEncoder(ctx, device=device)
    enc = T.Encryptor(ctx, pk, device=device)
    dec = T.Decryptor(ctx, kg.secret_key, device=device)
    scale = 2.0 ** 40
    vals = [1.001] * encoder.slot_count
    ct = enc.encrypt(encoder.encode(vals, scale))
    a = ct.data.expand((batch,) + tuple(ct.data.shape)).contiguous()

    set_phase("step")
    step = T.build_ckks_mul_relin_rescale(ctx, fused=True, device=device)
    square = T.build_ckks_mul_relin_rescale(ctx, fused=True, square=True, device=device)
    out, per_step = count_step(step, a, a, rk)

    set_phase("decrypt_decode")
    first_cd = ctx.first_context_data()
    next_cd = first_cd.next_context_data
    out_scale = scale * scale / first_cd.parms.coeff_modulus[-1].value
    got = encoder.decode(dec.decrypt(T.Ciphertext(out[0], next_cd.parms_id, True, out_scale)))
    want_sq = [v * v for v in vals]
    err = max_err(got, want_sq)
    end("mul_relin_rescale", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"mul_relin_rescale decodes to {err} from v^2")

    # a seeded non-constant vector, so that a rotation shows in the decode
    slots = encoder.slot_count
    v = np.random.default_rng(2024).uniform(-1.0, 1.0, slots)

    # 3b. train_step: the flagship step (sequential mul + rotate + add)
    t0 = begin("train_step")
    set_phase("keygen")
    elt1 = first_cd.galois_tool.get_elt_from_step(1)
    gk1 = kg.galois_keys([elt1]).stacked(elt1)
    keygen_done("train_step", t0)
    set_phase("encode_encrypt")
    ct_v = enc.encrypt(encoder.encode(v.tolist(), scale))
    av = ct_v.data.expand((batch,) + tuple(ct_v.data.shape)).contiguous()
    set_phase("step")
    train = T.build_ckks_train_step(ctx, rotate_steps=1, device=device)
    out, per_step = count_step(train, av, av, rk, gk1)
    set_phase("decrypt_decode")
    got = encoder.decode(dec.decrypt(T.Ciphertext(out[0], next_cd.parms_id, True, out_scale)))
    want_train = v * v + np.roll(v * v, -1)
    err = max_err(got, want_train)
    end("train_step", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"train_step decodes to {err} from v_i^2 + v_(i+1)^2")

    # 3c. rotate_many: hoisted rotations by steps 1..R from one mod-up, with
    # the plain and the counter-rotated keys
    t0 = begin("rotate_many")
    set_phase("keygen")
    gks = kg.galois_keys_from_steps(rot_steps)
    tool = first_cd.galois_tool
    elts = tool.get_elts_from_steps(rot_steps)
    keys_stack = gks.stacked(*elts)
    pkeys_stack = T.prepermute_galois_stack(tool, elts, keys_stack)
    keygen_done("rotate_many", t0)
    set_phase("encode_encrypt")
    ct_r = enc.encrypt(encoder.encode(v.tolist(), scale))
    ar = ct_r.data.expand((rot_batch,) + tuple(ct_r.data.shape)).contiguous()
    set_phase("step")
    rmany = T.build_ckks_rotate_many(ctx, rot_steps, device=device)
    rmany_pk = T.build_ckks_rotate_many(ctx, rot_steps, prepermuted_keys=True, device=device)
    out, per_step = count_step(rmany, ar, keys_stack)
    pout, per_step_pk = count_step(rmany_pk, ar, pkeys_stack)
    set_phase("decrypt_decode")
    err = form_err = 0.0
    for r, s in enumerate(rot_steps):
        got, pgot = (encoder.decode(dec.decrypt(T.Ciphertext(o[r, 0].contiguous(),
                                                              ct_r.parms_id, True,
                                                              ct_r.scale)))
                     for o in (out, pout))
        err = max(err, max_err(got, np.roll(v, -s)), max_err(pgot, np.roll(v, -s)))
        form_err = max(form_err, max_err(got, pgot))
    end("rotate_many", t0, [per_step, per_step_pk], out_shape=list(out.shape),
        max_abs_decode_err=err, max_abs_decode_diff_between_key_forms=form_err)
    if not (err < 1e-4 and form_err < 1e-5):
        raise AssertionError(f"rotate_many decodes to {err} from the shifted v, and the "
                             f"key forms {form_err} apart")

    # 3d-e. the BFV paths (BASELINE configs 3 and 1): each decodes v^2 mod t
    def bfv_context(n_bfv, coeff_modulus, sec_level):
        parms = T.EncryptionParameters(T.SchemeType.BFV)
        parms.set_poly_modulus_degree(n_bfv)
        parms.set_coeff_modulus(coeff_modulus)
        parms.set_plain_modulus(T.PlainModulus.batching(n_bfv, 20))
        parms.set_random_seed(tuple(range(8)))
        return T.SealContext(parms, sec_level=sec_level, device=device)

    def bfv_path(path, n_bfv, coeff_modulus, sec_level, chain):
        t0 = begin(path)
        set_phase("keygen")
        bctx = bfv_context(n_bfv, coeff_modulus, sec_level)
        bkg = T.KeyGenerator(bctx, device=device)
        brk = bkg.relin_keys().stacked(2)
        keygen_done(path, t0)
        set_phase("encode_encrypt")
        be = T.BatchEncoder(bctx, device=device)
        benc = T.Encryptor(bctx, bkg.public_key(), device=device)
        bdec = T.Decryptor(bctx, bkg.secret_key, device=device)
        t = bctx.first_context_data().parms.plain_modulus.value
        vb = np.random.default_rng(2025).integers(0, t, n_bfv)
        bct = benc.encrypt(be.encode(vb.tolist()))
        ab = bct.data.expand((batch,) + tuple(bct.data.shape)).contiguous()
        set_phase("step")
        if chain:
            fn = T.build_bfv_mul_relin_modswitch(bctx, fused_drop=True, device=device)
            out_id = bctx.last_parms_id
        else:
            fn = T.build_bfv_mul_relin(bctx, device=device)
            out_id = bctx.first_parms_id
        out, per_step = count_step(fn, ab, ab, brk)
        set_phase("decrypt_decode")
        want = (vb.astype(object) ** 2 % t).tolist()

        def decodes(data, parms_id=out_id):
            return be.decode(bdec.decrypt(T.Ciphertext(data, parms_id, False))) == want

        exact = decodes(out[0]) and decodes(out[-1])
        end(path, t0, per_step, out_shape=list(out.shape), n=n_bfv,
            levels_out=len(bctx.get_context_data(out_id).parms.coeff_modulus),
            decode_exact=exact)
        if not exact:
            raise AssertionError(f"{path} does not decode to v^2 mod t")
        return bctx, brk, ab, fn, decodes

    bfv_n3, bfv_n1 = (1024, 1024) if rehearsal else (8192, 4096)
    cfg3 = bfv_path("bfv_mul_relin_chain", bfv_n3,
                    T.CoeffModulus.create(bfv_n3, [50, 40, 40, 40, 50]),
                    T.SecLevelType.none, chain=True)
    cfg1 = bfv_path("bfv_mul_relin", bfv_n1,
                    T.CoeffModulus.create(bfv_n1, [36, 36, 37]) if rehearsal
                    else T.CoeffModulus.bfv_default(bfv_n1),
                    T.SecLevelType.none if rehearsal else T.SecLevelType.tc128, chain=False)

    # 3f. bfv_rotate_rows (BASELINE config 2): bench_all.py's composition
    from gemini_seal_tpu_torch.ops.dyadic import add_poly
    from gemini_seal_tpu_torch.ops.keyswitch import KeySwitchPlan, switch_key

    n2 = 1024 if rehearsal else 8192
    t0 = begin("bfv_rotate_rows")
    set_phase("keygen")
    ctx2 = bfv_context(n2, T.CoeffModulus.create(n2, [30, 30, 30]) if rehearsal
                       else T.CoeffModulus.bfv_default(n2),
                       T.SecLevelType.none if rehearsal else T.SecLevelType.tc128)
    kg2 = T.KeyGenerator(ctx2, device=device)
    cd2 = ctx2.first_context_data()
    tool2, limbs2 = cd2.galois_tool, cd2.limb_constants
    elt_r, elt_c = tool2.get_elt_from_step(1), 2 * n2 - 1
    gk2 = kg2.galois_keys([elt_r, elt_c])
    key_r, key_c = gk2.stacked(elt_r), gk2.stacked(elt_c)
    keygen_done("bfv_rotate_rows", t0)
    set_phase("encode_encrypt")
    be2 = T.BatchEncoder(ctx2, device=device)
    enc2 = T.Encryptor(ctx2, kg2.public_key(), device=device)
    dec2 = T.Decryptor(ctx2, kg2.secret_key, device=device)
    t2 = cd2.parms.plain_modulus.value
    v2 = np.random.default_rng(2026).integers(0, t2, n2)
    ct2 = enc2.encrypt(be2.encode(v2.tolist()))
    a2b = ct2.data.expand((batch,) + tuple(ct2.data.shape)).contiguous()
    set_phase("step")
    plan2 = KeySwitchPlan(ctx2, cd2.parms_id)
    tool2.coeff_tables([elt_r])
    tool2.coeff_tables([elt_c])

    def bfv_rotate(elt):
        def rotate(x, key):
            rot = tool2.apply_galois(x, elt, limbs2)                  # both components
            d0, d1 = switch_key(rot[..., 1, :, :], key, plan2, False)
            return torch.stack([add_poly(rot[..., 0, :, :].contiguous(), d0, limbs2), d1],
                               dim=-3)
        return rotate

    rot_rows, rot_cols = bfv_rotate(elt_r), bfv_rotate(elt_c)
    out, per_step = count_step(rot_rows, a2b, key_r)
    set_phase("decrypt_decode")
    half = n2 // 2

    def rows_rotated(s):
        return np.concatenate([np.roll(v2[:half], -s), np.roll(v2[half:], -s)]).tolist()

    def decodes2(data):
        return be2.decode(dec2.decrypt(T.Ciphertext(data.contiguous(), cd2.parms_id, False)))

    exact = decodes2(out[0]) == rows_rotated(1) and decodes2(out[-1]) == rows_rotated(1)
    end("bfv_rotate_rows", t0, per_step, out_shape=list(out.shape), decode_exact=exact)
    if not exact:
        raise AssertionError("bfv_rotate_rows does not decode to the rows rotated by one")

    # 3g. bfv_rotate_many (config 2'): steps 1..8 from one mod-up, both key forms
    hsteps = list(range(1, 3 if rehearsal else 9))
    t0 = begin("bfv_rotate_many")
    set_phase("keygen")
    helts = tool2.get_elts_from_steps(hsteps)
    hstack = kg2.galois_keys(helts).stacked(*helts)
    phstack = T.prepermute_galois_stack(tool2, helts, hstack)
    keygen_done("bfv_rotate_many", t0)
    set_phase("encode_encrypt")
    ct2h = enc2.encrypt(be2.encode(v2.tolist()))
    a2h = ct2h.data.expand((rot_batch,) + tuple(ct2h.data.shape)).contiguous()
    set_phase("step")
    bmany = T.build_bfv_rotate_many(ctx2, hsteps, device=device)
    bmany_pk = T.build_bfv_rotate_many(ctx2, hsteps, prepermuted_keys=True, device=device)
    out, per_step = count_step(bmany, a2h, hstack)
    pout, per_step_pk = count_step(bmany_pk, a2h, phstack)
    set_phase("decrypt_decode")
    exact = all(decodes2(o[r, b]) == rows_rotated(s) for o in (out, pout)
                for r, s in enumerate(hsteps) for b in (0, rot_batch - 1))
    end("bfv_rotate_many", t0, [per_step, per_step_pk], out_shape=list(out.shape),
        decode_exact=exact, key_forms_decode_equal=exact)
    if not exact:
        raise AssertionError("bfv_rotate_many does not decode to the rotated rows")

    def ckks_context(n_c, bits):
        parms = T.EncryptionParameters(T.SchemeType.CKKS)
        parms.set_poly_modulus_degree(n_c)
        parms.set_coeff_modulus(T.CoeffModulus.create(n_c, bits))
        parms.set_random_seed(tuple(range(8)))
        c = T.SealContext(parms, sec_level=T.SecLevelType.none, device=device)
        k = T.KeyGenerator(c, device=device)
        return (c, k, T.CKKSEncoder(c, device=device), T.Encryptor(c, k.public_key(), device=device),
                T.Decryptor(c, k.secret_key, device=device))

    # 3h. ckks_mul_relin_rescale_n16384 (BASELINE config 4): the sequential step
    n4 = 1024 if rehearsal else 16384
    t0 = begin("ckks_mul_relin_rescale_n16384")
    set_phase("keygen")
    ctx4, kg4, encoder4, enc4, dec4 = ckks_context(
        n4, [40, 30, 40] if rehearsal else [50, 40, 40, 40, 40, 50])
    rk4 = kg4.relin_keys().stacked(2)
    keygen_done("ckks_mul_relin_rescale_n16384", t0)
    set_phase("encode_encrypt")
    scale4 = 2.0 ** 30 if rehearsal else 2.0 ** 40
    v4 = np.random.default_rng(2027).uniform(-1.0, 1.0, n4 // 2)
    ct4 = enc4.encrypt(encoder4.encode(v4.tolist(), scale4))
    a4 = ct4.data.expand((batch,) + tuple(ct4.data.shape)).contiguous()
    set_phase("step")
    step4 = T.build_ckks_mul_relin_rescale(ctx4, device=device)
    out, per_step = count_step(step4, a4, a4, rk4)
    set_phase("decrypt_decode")
    cd4 = ctx4.first_context_data()
    scale4_out = scale4 * scale4 / cd4.parms.coeff_modulus[-1].value
    err = max(max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(
        out[b], cd4.next_context_data.parms_id, True, scale4_out))), v4 * v4)
        for b in (0, batch - 1))
    end("ckks_mul_relin_rescale_n16384", t0, per_step, out_shape=list(out.shape),
        max_abs_decode_err=err)
    if not err < 1e-4:
        raise AssertionError(f"ckks_mul_relin_rescale_n16384 decodes to {err} from v^2")
    ntt4 = a4.contiguous()

    # 3i. ckks_poly_eval_n32768 (BASELINE config 5): the deep polynomial
    n5 = 1024 if rehearsal else 32768
    coeffs5 = [1.0, -0.5, 0.25, 0.125, 0.0625]
    t0 = begin("ckks_poly_eval_n32768")
    set_phase("keygen")
    ctx5, kg5, encoder5, enc5, dec5 = ckks_context(
        n5, [59, 30, 30, 30, 59] if rehearsal else [59] + [40] * 6 + [59])
    rk5 = kg5.relin_keys().stacked(2)
    elts5 = ctx5.first_context_data().galois_tool.get_elts_from_steps([1, 2, 3])
    gk5 = kg5.galois_keys(elts5).stacked(*elts5)
    keygen_done("ckks_poly_eval_n32768", t0)
    set_phase("encode_encrypt")
    scale5 = 2.0 ** 30 if rehearsal else 2.0 ** 40
    v5 = np.random.default_rng(2028).uniform(-1.0, 1.0, n5 // 2)
    ct5 = enc5.encrypt(encoder5.encode(v5.tolist(), scale5))
    a5 = ct5.data.expand((batch,) + tuple(ct5.data.shape)).contiguous()
    set_phase("step")
    step5, deep5, out_scale5 = T.build_ckks_poly_eval(
        ctx5, coeffs5, scale5, encoder5, rotate_sum_log2=2, coeff_precision_bits=25,
        composed=True, rotate_mode="flat", device=device)
    out, per_step = count_step(step5, a5, rk5, gk5)
    set_phase("decrypt_decode")

    def p5(x):
        return sum(c * x ** k for k, c in enumerate(coeffs5))

    want5 = sum(p5(np.roll(v5, -j)) for j in range(4))
    err = max(max_err(encoder5.decode(dec5.decrypt(T.Ciphertext(out[b], deep5, True,
                                                                 out_scale5))), want5)
              for b in (0, batch - 1))
    end("ckks_poly_eval_n32768", t0, per_step, out_shape=list(out.shape),
        max_abs_decode_err=err)
    if not err < 1e-3:
        raise AssertionError(f"ckks_poly_eval_n32768 decodes {err} from sum p(v_(i+j))")

    # 3j. n65536: SEAL's cap; the NTT both ways, then the sequential step
    n6 = 2048 if rehearsal else 65536
    b6 = 2 if rehearsal else 16
    t0 = begin("n65536")
    set_phase("keygen")
    ctx6, kg6, encoder6, enc6, dec6 = ckks_context(n6, [50, 40, 40, 50])
    rk6 = kg6.relin_keys().stacked(2)
    keygen_done("n65536", t0)
    set_phase("ntt")
    cd6 = ctx6.first_context_data()
    rng6 = np.random.default_rng(9)
    x6 = to_tensor(np.stack([rng6.integers(0, m.value, (b6, 2, n6), dtype=np.uint64)
                             for m in cd6.parms.coeff_modulus], axis=2), device)
    f6 = ntt_ops.ntt_forward(x6, cd6.ntt_tables)
    i6 = ntt_ops.ntt_inverse(f6, cd6.ntt_tables)
    ntt_round_trip = bool(torch.equal(i6, x6))
    set_phase("encode_encrypt")
    vals6 = [0.5, -1.25, 2.0]
    ct6 = enc6.encrypt(encoder6.encode(vals6, 2.0 ** 40))
    a6 = ct6.data.expand((b6,) + tuple(ct6.data.shape)).contiguous()
    set_phase("step")
    step6 = T.build_ckks_mul_relin_rescale(ctx6, device=device)
    out, per_step = count_step(step6, a6, a6, rk6)
    set_phase("decrypt_decode")
    scale6 = 2.0 ** 80 / cd6.parms.coeff_modulus[-1].value
    want6 = [x * x for x in vals6] + [0.0] * (n6 // 2 - len(vals6))
    err = max(max_err(encoder6.decode(dec6.decrypt(T.Ciphertext(
        out[b], cd6.next_context_data.parms_id, True, scale6))), want6) for b in (0, b6 - 1))
    end("n65536", t0, per_step, out_shape=list(out.shape), max_abs_decode_err=err,
        ntt_round_trip_exact=ntt_round_trip)
    if not (err < 1e-4 and ntt_round_trip):
        raise AssertionError(f"n65536 decodes {err} from v^2 (NTT round trip "
                             f"exact: {ntt_round_trip})")
    recorder.remove()
    for kernel, row in rows.items():
        emit({"phase": "kernel_check", "kernel": kernel, "equal": True, **row})

    # 5. batch 2 of each step against the plain path on the card -----------------
    seq = T.build_ckks_mul_relin_rescale(ctx, device=device)
    a2, av2, ar2 = a[:2].contiguous(), av[:2].contiguous(), ar[:2].contiguous()
    checks = (("multiply", step, (a2, a2, rk)), ("square", square, (a2, rk)),
              ("sequential_multiply", seq, (av2, av2, rk)),
              ("train_step", train, (av2, av2, rk, gk1)),
              ("rotate_many", rmany, (ar2, keys_stack)),
              ("rotate_many_prepermuted", rmany_pk, (ar2, pkeys_stack)))
    for name, fn, fargs in checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        if name.startswith("rotate_many"):
            pt = dec.decrypt(T.Ciphertext(got_k[-1, 1].contiguous(), ct_r.parms_id, True,
                                          ct_r.scale))
            err = max_err(encoder.decode(pt), np.roll(v, -rot_steps[-1]))
        else:
            want = want_train if name == "train_step" else (
                v * v if name == "sequential_multiply" else want_sq)
            err = max_err(encoder.decode(dec.decrypt(
                T.Ciphertext(got_k[1], next_cd.parms_id, True, out_scale))), want)
        if not err < 1e-4:
            raise AssertionError(f"batch-2 {name} decodes {err} from its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True,
              "max_abs_decode_err": err})
    bctx3, brk3, ab3, chain3, decodes3 = cfg3
    bctx1, brk1, ab1, mul1, decodes1 = cfg1
    b3, b1 = ab3[:2].contiguous(), ab1[:2].contiguous()
    chain3_seq = T.build_bfv_mul_relin_modswitch(bctx3, fused_drop=False, device=device)
    mul3 = T.build_bfv_mul_relin(bctx3, device=device)
    sq3 = T.build_bfv_mul_relin(bctx3, square=True, device=device)
    first3 = bctx3.first_parms_id
    swapped = np.concatenate([v2[half:], v2[:half]]).tolist()
    b2r, b2h = a2b[:2].contiguous(), a2h[:2].contiguous()
    bfv_checks = (
        ("bfv_chain_fused_drop", chain3, (b3, b3, brk3), decodes3),
        ("bfv_chain_per_level_drop", chain3_seq, (b3, b3, brk3), decodes3),
        ("bfv_multiply_n8192", mul3, (b3, b3, brk3), lambda d: decodes3(d, first3)),
        ("bfv_square_n8192", sq3, (b3, brk3), lambda d: decodes3(d, first3)),
        ("bfv_multiply_n4096", mul1, (b1, b1, brk1), decodes1),
        ("bfv_rotate_rows", rot_rows, (b2r, key_r), lambda d: decodes2(d) == rows_rotated(1)),
        ("bfv_rotate_columns", rot_cols, (b2r, key_c), lambda d: decodes2(d) == swapped),
        ("bfv_rotate_many", bmany, (b2h, hstack),
         lambda d: decodes2(d[-1]) == rows_rotated(hsteps[-1])),
        ("bfv_rotate_many_prepermuted", bmany_pk, (b2h, phstack),
         lambda d: decodes2(d[-1]) == rows_rotated(hsteps[-1])),
    )
    for name, fn, fargs, decodes in bfv_checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        if not decodes(got_k[1] if got_k.dim() == 4 else got_k[:, 1]):
            raise AssertionError(f"batch-2 {name} does not decode to its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True, "decode_exact": True})
    large_checks = (
        ("ckks_mul_relin_rescale_n16384", step4, (a4[:2].contiguous(),) * 2 + (rk4,),
         lambda d: max_err(encoder4.decode(dec4.decrypt(T.Ciphertext(
             d, cd4.next_context_data.parms_id, True, scale4_out))), v4 * v4), 1e-4),
        ("ckks_poly_eval_n32768", step5, (a5[:2].contiguous(), rk5, gk5),
         lambda d: max_err(encoder5.decode(dec5.decrypt(T.Ciphertext(
             d, deep5, True, out_scale5))), want5), 1e-3),
        ("n65536", step6, (a6[:2].contiguous(),) * 2 + (rk6,),
         lambda d: max_err(encoder6.decode(dec6.decrypt(T.Ciphertext(
             d, cd6.next_context_data.parms_id, True, scale6))), want6), 1e-4),
    )
    for name, fn, fargs, decode_err, tol in large_checks:
        got_k = fn(*fargs)
        with plain_versions():
            got_p = fn(*fargs)
        sync()
        if not torch.equal(got_k, got_p):
            raise AssertionError(f"batch-2 {name} differs from the plain path")
        err = decode_err(got_k[1])
        if not err < tol:
            raise AssertionError(f"batch-2 {name} decodes {err} from its expectation")
        emit({"phase": "batch2", "form": name, "equal_to_plain": True,
              "max_abs_decode_err": err})
        del got_k, got_p

    # the power-basis limb drop of config 3's per-level chain at batch 128,
    # timed as a function (its four launches together) beside its bound
    from gemini_seal_tpu_torch.ops import rnsops

    drop_in = mul3(ab3, ab3, brk3)
    tool3 = bctx3.first_context_data().device_rns_tool
    drop_out, drop_launches = count_step(rnsops.divide_and_round_q_last, drop_in, tool3)
    drop_bytes = bytes_once([drop_in]) + bytes_once([drop_out])
    drop_ops = (drop_out.numel() * (IMAD_MAC + IMAD_BARRETT128 + IMAD_MULMOD)
                + drop_out.numel() // drop_out.shape[-2] * IMAD_BARRETT64)
    drop = {"phase": "function", "function": "divide_and_round_q_last",
            "input_shape": list(drop_in.shape),
            "launches": {k: c for k, c in by_label(drop_launches).items() if c},
            "bytes": drop_bytes, "imads": drop_ops,
            "bound_ms": max(drop_bytes / HBM_BYTES_PER_S, drop_ops / INT32_IMAD_PER_S) * 1e3,
            "bound_by": "operations" if drop_ops / INT32_IMAD_PER_S
                        > drop_bytes / HBM_BYTES_PER_S else "bytes", "card": card}
    with plain_versions():
        if not torch.equal(rnsops.divide_and_round_q_last(drop_in, tool3), drop_out):
            raise AssertionError("divide_and_round_q_last differs from its plain version")
    if not rehearsal:
        drop["ms"] = event_ms(torch, lambda: rnsops.divide_and_round_q_last(drop_in, tool3),
                              reps)
        with plain_versions():
            drop["plain_ms"] = event_ms(
                torch, lambda: rnsops.divide_and_round_q_last(drop_in, tool3), 2)
    emit(drop)
    del drop_in, drop_out

    # 6. steady state at each path's full batch --------------------------------
    # (path, metric, count per call, call, batch); a pair in one tuple is
    # timed in turns: A, B, A, B
    tables4, tables6 = cd4.ntt_tables, cd6.ntt_tables
    timed = [
        ("mul_relin_rescale", "ckks_mul_relin_rescale_n8192_ops_per_s", batch,
         lambda: step(a, a, rk), batch),
        ("mul_relin_rescale_sequential", "ckks_mul_relin_rescale_sequential_n8192_ops_per_s",
         batch, lambda: seq(a, a, rk), batch),
        ("train_step", "ckks_train_step_n8192_ops_per_s", batch,
         lambda: train(av, av, rk, gk1), batch),
        (("rotate_many", "ckks_rotate_many_n8192_rotations_per_s",
          rot_batch * len(rot_steps), lambda: rmany(ar, keys_stack), rot_batch),
         ("rotate_many_prepermuted", "ckks_rotate_many_prepermuted_n8192_rotations_per_s",
          rot_batch * len(rot_steps), lambda: rmany_pk(ar, pkeys_stack), rot_batch)),
        ("bfv_mul_relin_chain", "bfv_mul_relin_chain_n8192_ops_per_s", batch,
         lambda: chain3(ab3, ab3, brk3), batch),
        ("bfv_mul_relin_n8192", "bfv_mul_relin_n8192_ops_per_s", batch,
         lambda: mul3(ab3, ab3, brk3), batch),
        ("bfv_square_relin_n8192", "bfv_square_relin_n8192_ops_per_s", batch,
         lambda: sq3(ab3, brk3), batch),
        ("bfv_mul_relin", "bfv_mul_relin_n4096_ops_per_s", batch,
         lambda: mul1(ab1, ab1, brk1), batch),
        ("bfv_rotate_rows", "bfv_rotate_rows_n8192_ops_per_s", batch,
         lambda: rot_rows(a2b, key_r), batch),
        (("bfv_rotate_many", "bfv_rotate_rows_hoisted8_n8192_rot_per_s",
          rot_batch * len(hsteps), lambda: bmany(a2h, hstack), rot_batch),
         ("bfv_rotate_many_prepermuted", "bfv_rotate_rows_hoisted8_prepermuted_n8192_rot_per_s",
          rot_batch * len(hsteps), lambda: bmany_pk(a2h, phstack), rot_batch)),
        ("ckks_mul_relin_rescale_n16384", "ckks_mul_relin_rescale_n16384_ops_per_s", batch,
         lambda: step4(a4, a4, rk4), batch),
        ("ntt_n16384", "ntt_n16384_per_s", ntt4.numel() // n4,
         lambda: ntt_ops.ntt_forward(ntt4, tables4), batch),
        ("ckks_poly_eval_n32768", "ckks_deep_poly4_rot_n32768_ops_per_s", batch,
         lambda: step5(a5, rk5, gk5), batch),
        ("ntt_fwd_n65536", "ntt_fwd_n65536_rows_per_s", x6.numel() // n6,
         lambda: ntt_ops.ntt_forward(x6, tables6), b6),
        ("ntt_inv_n65536", "ntt_inv_n65536_rows_per_s", x6.numel() // n6,
         lambda: ntt_ops.ntt_inverse(x6, tables6), b6),
        ("n65536", "ckks_mul_relin_rescale_n65536_ops_per_s", b6,
         lambda: step6(a6, a6, rk6), b6),
    ]
    keygen_of = {"mul_relin_rescale_sequential": "mul_relin_rescale",
                 "bfv_mul_relin_n8192": "bfv_mul_relin_chain",
                 "bfv_square_relin_n8192": "bfv_mul_relin_chain",
                 "rotate_many_prepermuted": "rotate_many",
                 "bfv_rotate_many_prepermuted": "bfv_rotate_many",
                 "ntt_n16384": "ckks_mul_relin_rescale_n16384",
                 "ntt_fwd_n65536": "n65536", "ntt_inv_n65536": "n65536"}
    if not rehearsal:
        for entry in timed:
            turns = [(entry, 1)] if isinstance(entry[0], str) else [
                (entry[0], 1), (entry[1], 1), (entry[0], 2), (entry[1], 2)]
            for (path, metric, count, fn, b), turn in turns:
                torch.cuda.reset_peak_memory_stats()
                rate, iters, dt = steady(torch, fn, count)
                peak = torch.cuda.max_memory_allocated()
                prof = profile_steps(torch, fn, 10, dt * 1e3 / iters)
                emit({"phase": "steady_state", "path": path, "metric": metric, "value": rate,
                      "batch": b, "turn": turn, "iters": iters, "seconds": dt,
                      "device_ms_per_step": prof["device_ms_per_step"],
                      "device_busy_share": prof["device_busy_share"],
                      "keygen_seconds": keygen_s[keygen_of.get(path, path)],
                      "peak_device_bytes": peak, "card": card})
                emit({"phase": "profile", "path": path, "turn": turn, **prof})
        emit({"phase": "memory", "peak_device_bytes_with_checks_by_path":
              {p: v["peak_device_bytes_with_checks"] for p, v in paths.items()}, "card": card})

    # 7. kernels line and result line -----------------------------------------------
    replaces = {
        "ntt": "gemini_seal_tpu/ops/ntt.py:241 ntt_forward_lazy, :322 ntt_inverse_lazy",
        "ntt:large_ring": "gemini_seal_tpu/ops/ntt.py:241 ntt_forward_lazy, :322 "
                          "ntt_inverse_lazy at N = 32768, 65536",
        "tensor_product": "gemini_seal_tpu/models/pipelines.py:72 _convolve3, :87 _square3",
        "contract": "gemini_seal_tpu/ops/modops.py:218 accumulate_mulmod_128",
        "contract:broadcast": "gemini_seal_tpu/models/pipelines.py:318 "
                              "_shared_digit_inner_product",
        "elementwise": "gemini_seal_tpu/ops/keyswitch.py:438 fused_moddown mul_mod/add_mod "
                       "epilogues; gemini_seal_tpu/ops/rnsops.py:356 fast_floor, :182 "
                       "divide_and_round_q_last, :463 divide_and_round_multi",
        "galois": "gemini_seal_tpu/ops/galois.py:123 apply_galois_ntt",
        "galois:signed": "gemini_seal_tpu/ops/galois.py:115 apply_galois; "
                         "gemini_seal_tpu/models/pipelines.py:403 build_bfv_rotate_many's "
                         "signed gather of c0",
        "galois:paired": "gemini_seal_tpu/models/pipelines.py:483 build_ckks_rotate_many's "
                         "take_along_axis (counter-rotated keys), :291 "
                         "prepermute_galois_stack",
        "galois:signed_paired": "gemini_seal_tpu/models/pipelines.py:389 "
                                "build_bfv_rotate_many's take_along_axis and sign flip "
                                "(counter-rotated keys)",
        "behz": "gemini_seal_tpu/ops/rnsops.py:329 sm_mrq, :369 fastbconv_sk",
        "scale_round": "gemini_seal_tpu/ops/rnsops.py:256 multiply_add_plain_with_scaling_variant, "
                       ":287 multiply_sub_plain_with_scaling_variant, :145 "
                       "decrypt_scale_and_round",
    }
    sources = {k: f"gemini_seal_tpu_torch/csrc/{v[0]}" for k, v in cuda.KERNELS.items()}
    library_calls = {
        "galois": "torch.index_select (one table) / torch.gather (R tables) over the last axis",
        "galois:paired": "torch.gather over the last axis",
        "galois:signed": "the permutation part: torch.index_select / torch.gather (no PyTorch "
                         "call flips the signs mod p)",
        "galois:signed_paired": "the permutation part: torch.gather (no PyTorch call flips "
                                "the signs mod p)",
    }
    kernels = []
    for label, row in rows.items():
        bp = row["by_path"]
        total = {f: sum(p[f] for p in bp.values())
                 for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "imads")}
        is_galois = label.startswith("galois")
        fields = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if is_galois else ())
        kernels.append({
            "name": label, "route": "cuda", "source": sources[label.split(":")[0]],
            "replaces": replaces[label],
            "launches": sum(p["launches"][label] for p in paths.values()),
            "launches_by_path": {p: paths[p]["launches"][label] for p in paths},
            # a path with two forms (the two key forms) lists each form's
            "launches_per_step": {p: [f[label] for f in paths[p]["launches_per_step_by_form"]]
                                  if "launches_per_step_by_form" in paths[p]
                                  else paths[p]["launches_per_step"][label] for p in paths},
            "max_abs_err": row["max_abs_err"],
            "ms": total["ms"] if not rehearsal and bp else None,
            "plain_ms": total["plain_ms"] if not rehearsal and bp else None,
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if total["imads"] / INT32_IMAD_PER_S
                        > total["bytes"] / HBM_BYTES_PER_S else "bytes",
            "library_ms": total["library_ms"] if is_galois and not rehearsal and bp else None,
            "library_call": library_calls.get(label, "none: no PyTorch call computes u64 "
                                                     "modular arithmetic"),
            "timed_calls": ("encryption and decryption (no step launches it)"
                            if label == "scale_round" else
                            "none: no step launches it" if not bp else "each path's step"),
            "per_step_by_path": {p: {f: v[f] if f == "bound_ms" or not rehearsal else None
                                     for f in fields}
                                 for p, v in bp.items()},
        })
    emit({"kernels": kernels})
    if rehearsal:
        emit({"ok": True, "rehearsal": "cpu"})
        return 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
