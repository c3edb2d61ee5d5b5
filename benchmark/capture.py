"""The work of one step, by kernel family, from the shapes its calls read
and write.

Each work/<family>.py names the program's wrapper functions that launch
the family's kernels (WRAPPERS) and counts a call's bytes and 32-bit
multiplies (work).  For one step, run outside the measured window, every
module of the program that holds such a wrapper gets a counting twin in
its place; the originals are put back before the step returns."""

from __future__ import annotations

import importlib
import sys


def step_work(call, work_modules: dict, package: str = "gemini_seal_tpu_torch") -> dict:
    """family -> [(bytes, imads)] of each call of the family in call()."""
    calls = {fam: [] for fam in work_modules}
    originals = {}
    for fam, mod in work_modules.items():
        for mod_name, names in mod.WRAPPERS.items():
            src = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(src, name)
                originals[id(fn)] = (fn, fam, name, mod)

    def twin(fn, fam, name, mod):
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[fam].append(mod.work(name, args, kwargs, out))
            return out
        return counted

    twins = {key: twin(*v) for key, v in originals.items()}
    patched = []
    try:
        for mod_name, module in list(sys.modules.items()):
            if module is None or mod_name.split(".")[0] != package:
                continue
            for attr, value in list(vars(module).items()):
                hit = originals.get(id(value))
                if hit is not None and hit[0] is value:
                    setattr(module, attr, twins[id(value)])
                    patched.append((module, attr, value))
        call()
    finally:
        for module, attr, value in patched:
            setattr(module, attr, value)
    return calls


def bound_s(calls, peaks: dict) -> float:
    """The least time of the calls at the card's peaks: per call the larger
    of its bytes at the memory bandwidth and its IMADs at the integer rate,
    summed."""
    bw, imad = peaks["hbm_bytes_per_s"], peaks["int32_imad_per_s"]
    return sum(max(b / bw, i / imad) for b, i in calls)
