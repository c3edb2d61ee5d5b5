#!/usr/bin/env python3
"""Tables of chip_smoke.py runs side by side, for PERF.md.

    python3 port_tools/smoke_tables.py RUN.log [RUN.log ...] [--kernels ntt,galois]

Each RUN.log is the standard output of one ``python3 chip_smoke.py`` run
(its JSON lines).  Prints, as markdown, one column per run:

- the card line of each run (nvidia-smi name and power limit);
- per path of the steady state: the rate, the device ms a step and the
  busy share (``steady_state`` lines; a path timed in two turns gives
  both, first / second);
- per kernel label of ``--kernels`` (by default every ``ntt`` and
  ``galois`` label) and per path: the summed ms of the step's calls, with
  the bound and the library call's ms of the first run (``kernels`` line);
- per path: K3 ``contract`` in all its modes (``contract``,
  ``contract:broadcast`` and ``contract:pairwise`` summed): the ms a step of the step's calls, the
  launches a step, and the bound and plain ms of the first run
  (``kernels`` line);
- per path: the device ms a step of K1 (kernels named ``ntt_kernel``, and
  ``ntt_stage_kernel``, the large-ring stage launches of the kernel's
  earlier design, so that an older tree's run compares), K3
  (``contract_kernel``), K5 (``galois_kernel``) and K6 (``sm_mrq_kernel``
  and ``sk_tail_kernel``) (``profile`` lines, first turn);
- the four-step int8 NTT against K1 (``ntt_mxu`` lines): the MXU/K1 ratio
  of NTTs/s both ways and the CUDA-event ms a transform of each;
- K6 ``behz`` per mode and path: the ms a step of the step's calls, their
  count, and the bound and plain ms of the first run; K7 ``scale_round``
  per path, mode and distinct call: its ms in each run, with the bound and
  plain ms of the first run, and the sum over every call of the paths
  (``kernel_check`` lines: their ``step_calls``, so that a run of a tree
  without per-mode rows compares too); the launch floor of each run
  (``launch_floor`` line).
"""

import argparse
import json


def read(path):
    lines = []
    card = None
    with open(path, errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("{"):
                try:
                    lines.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
            elif card is None and "W" in line and "," in line:
                card = line
    return card, lines


def fmt(v, digits=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel labels (default: every ntt and galois label)")
    args = ap.parse_args(argv)
    runs = [read(p) for p in args.runs]
    print("| run | card |\n|---|---|")
    for p, (card, _) in zip(args.runs, runs):
        print(f"| {p} | {card} |")

    # steady state
    steady = []
    for _, lines in runs:
        d = {}
        for o in lines:
            if o.get("phase") == "steady_state":
                d.setdefault(o["path"], []).append(o)
        steady.append(d)
    paths = list(dict.fromkeys(p for d in steady for p in d))
    print("\n| path | " + " | ".join(f"rate, device ms, busy ({i + 1})" for i in range(len(runs)))
          + " |")
    print("|---|" + "---|" * len(runs))
    for path in paths:
        cells = []
        for d in steady:
            obs = d.get(path, [])
            cells.append(" / ".join(f"{fmt(o['value'])}, {fmt(o['device_ms_per_step'])}, "
                                    f"{o['device_busy_share']:.0%}" for o in obs) or "-")
        print(f"| {path} | " + " | ".join(cells) + " |")

    # kernels line
    klines = []
    for _, lines in runs:
        k = next((o["kernels"] for o in lines if isinstance(o.get("kernels"), list)), [])
        klines.append({row["name"]: row for row in k})
    labels = (args.kernels.split(",") if args.kernels else
              [n for n in klines[0] if n.split(":")[0] in ("ntt", "galois")])
    for label in labels:
        rows = [k.get(label) for k in klines]
        if rows[0] is None:
            continue
        bpaths = list(dict.fromkeys(p for r in rows if r for p in r["per_step_by_path"]))
        print(f"\n**{label}** (ms a step, summed over the step's calls)\n")
        print("| path | " + " | ".join(f"ms ({i + 1})" for i in range(len(runs)))
              + " | bound | library |")
        print("|---|" + "---|" * (len(runs) + 2))
        for path in bpaths:
            ms = [fmt(r["per_step_by_path"].get(path, {}).get("ms")) if r else "-"
                  for r in rows]
            first = rows[0]["per_step_by_path"].get(path, {})
            print(f"| {path} | " + " | ".join(ms)
                  + f" | {fmt(first.get('bound_ms'))} | {fmt(first.get('library_ms'))} |")
        tot = [fmt(r["ms"]) if r else "-" for r in rows]
        print("| all | " + " | ".join(tot) + f" | {fmt(rows[0]['bound_ms'])} | "
              f"{fmt(rows[0].get('library_ms'))} |")

    # K3 in all its modes
    k3 = [[k.get(label) for label in ("contract", "contract:broadcast", "contract:pairwise")]
          for k in klines]
    if any(r for rows in k3 for r in rows):
        def launches(row, path):
            v = row["launches_per_step"].get(path, 0) if row else 0
            return v[0] if isinstance(v, list) else v

        print("\n**K3 contract, all modes** (ms a step summed over the step's calls; "
              "launches a step, the first form of a two-form path)\n")
        print("| path | " + " | ".join(f"ms, launches ({i + 1})" for i in range(len(runs)))
              + " | bound | plain |")
        print("|---|" + "---|" * (len(runs) + 2))
        kpaths = list(dict.fromkeys(p for rows in k3 for r in rows if r
                                    for p in r["per_step_by_path"]))
        for path in kpaths:
            cells = []
            for rows in k3:
                ms = [r["per_step_by_path"].get(path, {}).get("ms") for r in rows if r]
                ms = [v for v in ms if v is not None]
                cells.append(f"{fmt(sum(ms)) if ms else '-'}, "
                             f"{sum(launches(r, path) for r in rows)}")
            first = [r["per_step_by_path"].get(path, {}) for r in k3[0] if r]
            bound = sum(f.get("bound_ms") or 0 for f in first)
            plain = sum(f.get("plain_ms") or 0 for f in first)
            print(f"| {path} | " + " | ".join(cells) + f" | {fmt(bound)} | {fmt(plain)} |")

    # K6 per mode and K7 per call, from the kernel_check lines' timed calls
    def calls_of(lines, kernel):
        row = next((o for o in lines if o.get("phase") == "kernel_check"
                    and o.get("kernel") == kernel), None)
        out = {}
        for c in row["step_calls"] if row else []:
            mode = c.get("mode") or c["signature"].split("'")[1]
            out.setdefault((c["path"], mode), []).append(c)
        return out

    k6 = [calls_of(lines, "behz") for _, lines in runs]
    if any(k6):
        print("\n**K6 behz by mode** (ms a step summed over the step's calls; calls a step)\n")
        print("| path, mode | " + " | ".join(f"ms ({i + 1})" for i in range(len(runs)))
              + " | calls | bound | plain |")
        print("|---|" + "---|" * (len(runs) + 3))
        for key in dict.fromkeys(k for d in k6 for k in d):
            ms = [sum(c["ms"] or 0 for c in d[key]) if key in d else None for d in k6]
            first = next(d[key] for d in k6 if key in d)
            print(f"| {key[0]}, {key[1]} | " + " | ".join(fmt(v) for v in ms)
                  + f" | {len(first)} | {fmt(sum(c['bound_ms'] for c in first))} | "
                  f"{fmt(sum(c['plain_ms'] or 0 for c in first))} |")
    k7 = [calls_of(lines, "scale_round") for _, lines in runs]
    if any(k7):
        print("\n**K7 scale_round by call** (ms a call; the distinct calls of each path)\n")
        print("| path, mode, input | " + " | ".join(f"ms ({i + 1})" for i in range(len(runs)))
              + " | bound | plain |")
        print("|---|" + "---|" * (len(runs) + 2))
        for key in dict.fromkeys(k for d in k7 for k in d):
            sigs = dict.fromkeys(c["signature"] for d in k7 for c in d.get(key, []))
            for sig in sigs:
                ms = [next((c["ms"] for c in d.get(key, []) if c["signature"] == sig), None)
                      for d in k7]
                first = next(c for d in k7 for c in d.get(key, []) if c["signature"] == sig)
                shape = sig.split("(", 2)[2].split(")")[0]
                print(f"| {key[0]}, {key[1]}, ({shape}) | " + " | ".join(fmt(v) for v in ms)
                      + f" | {fmt(first['bound_ms'])} | {fmt(first['plain_ms'])} |")
        print("| all calls, summed | " + " | ".join(
            fmt(sum(c["ms"] or 0 for cs in d.values() for c in cs)) for d in k7)
            + f" | {fmt(sum(c['bound_ms'] for cs in k7[0].values() for c in cs))} | |")
    floors = [next((o["ms"] for o in lines if o.get("phase") == "launch_floor"), None)
              for _, lines in runs]
    if any(floors):
        print("\n| launch floor (empty kernel, ms) | " + " | ".join(
            ", ".join(f"{g} {fmt(v)}" for g, v in f.items()) if f else "-" for f in floors)
            + " |")
        print("|---|" + "---|" * len(runs))

    # profiles
    prof = []
    for _, lines in runs:
        d = {}
        for o in lines:
            if o.get("phase") == "profile" and o.get("turn", 1) == 1 and o["path"] not in d:
                d[o["path"]] = o
        prof.append(d)
    ppaths = list(dict.fromkeys(p for d in prof for p in d))
    print("\n| path (profile, ms a step) | "
          + " | ".join(f"K1, K3, K5, K6, all ({i + 1})" for i in range(len(runs))) + " |")
    print("|---|" + "---|" * len(runs))
    for path in ppaths:
        cells = []
        for d in prof:
            o = d.get(path)
            if o is None:
                cells.append("-")
                continue
            k1 = sum(r["device_ms_per_step"] for r in o["by_kernel"]
                     if "ntt_kernel" in r["name"] or "ntt_stage_kernel" in r["name"])
            k3 = sum(r["device_ms_per_step"] for r in o["by_kernel"]
                     if "contract_kernel" in r["name"])
            k5 = sum(r["device_ms_per_step"] for r in o["by_kernel"]
                     if "galois_kernel" in r["name"])
            k6 = sum(r["device_ms_per_step"] for r in o["by_kernel"]
                     if "sm_mrq_kernel" in r["name"] or "sk_tail_kernel" in r["name"])
            cells.append(f"{fmt(k1)}, {fmt(k3)}, {fmt(k5)}, {fmt(k6)}, "
                         f"{fmt(o['device_ms_per_step'])}")
        print(f"| {path} | " + " | ".join(cells) + " |")

    # the four-step int8 NTT against K1
    print("\n| ntt_mxu path | " + " | ".join(
        f"MXU/K1 fwd, inv; ms MXU fwd, K1 fwd, MXU inv, K1 inv ({i + 1})"
        for i in range(len(runs))) + " |")
    print("|---|" + "---|" * len(runs))
    mxu = [{o["path"]: o for o in lines if o.get("phase") == "ntt_mxu"} for _, lines in runs]
    for path in dict.fromkeys(p for d in mxu for p in d):
        cells = []
        for d in mxu:
            o = d.get(path)
            if o is None:
                cells.append("-")
                continue
            ms = o["device_ms_per_transform"]
            cells.append(f"{o['mxu_over_k1']['forward']:.3f}, {o['mxu_over_k1']['inverse']:.3f}; "
                         + ", ".join(fmt(ms[k][0]) for k in ("mxu_forward", "k1_forward",
                                                              "mxu_inverse", "k1_inverse")))
        print(f"| {path} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
