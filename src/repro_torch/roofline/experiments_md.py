"""Assemble a Markdown report of the port's dry run and of the benchmark
CSVs (the counterpart of ``repro/roofline/experiments_md.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --perf \\
        --out experiments/perf_torch
    PYTHONPATH=src python -m repro_torch.roofline.experiments_md

The tables are the reference's; the text is the port's: its method (a
step counted on ``meta`` tensors) and its peaks (the card's, from
``launch/mesh.py``). It states no time of any device: every number in it
is a count or a time derived from a count and a published peak.
"""
from __future__ import annotations

import argparse
import csv
import os
import statistics as st
from collections import defaultdict

from ..launch import mesh as M
from .report import dryrun_table, load, roofline_table


def bench_rows(name: str) -> list[dict]:
    path = f"experiments/bench/{name}.csv"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def md_table(rows: list[dict], cols: list[str]) -> str:
    out = ["| " + " | ".join(cols) + " |",
           "|" + "---|" * len(cols)]
    for r in rows:
        out.append("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    return "\n".join(out)


def agg_fig7() -> list[dict]:
    rows = bench_rows("fig7_comparison")
    agg = defaultdict(list)
    for r in rows:
        agg[(r["dataset"], r["algo"])].append(r)
    out = []
    for (ds, algo), rs in sorted(agg.items()):
        def m(k, rs=rs):
            return st.mean(float(r[k]) for r in rs)
        out.append({"dataset": ds, "algo": algo,
                    "largest": f"{m('largest'):.2f}",
                    "nstdev": f"{m('nstdev'):.3f}",
                    "messages": f"{m('messages'):.0f}",
                    "gain": f"{m('gain'):.3f}",
                    "connected": f"{m('connected'):.2f}",
                    "rounds": f"{m('rounds'):.0f}"})
    return out


def agg_fig5() -> list[dict]:
    rows = bench_rows("fig5_k_sweep")
    agg = defaultdict(list)
    for r in rows:
        agg[(r["dataset"], int(r["k"]), r["algo"])].append(r)
    out = []
    for (ds, k, algo), rs in sorted(agg.items()):
        def m(kk, rs=rs):
            return st.mean(float(r[kk]) for r in rs)
        out.append({"dataset": ds, "K": k, "algo": algo,
                    "rounds": f"{m('rounds'):.0f}",
                    "largest": f"{m('largest'):.2f}",
                    "nstdev": f"{m('nstdev'):.3f}",
                    "messages": f"{m('messages'):.0f}",
                    "gain": f"{m('gain'):.3f}"})
    return out


def agg_fig6() -> list[dict]:
    rows = bench_rows("fig6_diameter")
    agg = defaultdict(list)
    for r in rows:
        agg[(float(r["remap_frac"]), int(r["diameter_proxy"]))].append(r)
    out = []
    for (frac, diam), rs in sorted(agg.items(), key=lambda kv: -kv[0][1]):
        def m(kk, rs=rs):
            return st.mean(float(r[kk]) for r in rs)
        out.append({"remap_frac": frac, "diameter(ecc)": diam,
                    "rounds": f"{m('rounds'):.0f}",
                    "largest": f"{m('largest'):.2f}",
                    "nstdev": f"{m('nstdev'):.3f}",
                    "messages": f"{m('messages'):.0f}",
                    "gain": f"{m('gain'):.3f}",
                    "disconnected%": f"{m('disconnected_pct'):.1f}"})
    return out


def perf_compare(base: list[dict], tuned: list[dict]) -> list[dict]:
    tmap = {(r["arch"], r["shape"]): r for r in tuned
            if r.get("status") == "ok" and r.get("mesh") == "16x16"}
    out = []
    for r in base:
        if r.get("status") != "ok" or r.get("mesh") != "16x16":
            continue
        t = tmap.get((r["arch"], r["shape"]))
        if not t:
            continue
        rb, rt = r["roofline"], t["roofline"]
        bb = max(rb["compute_s"], rb["memory_s"], rb["collective_s"])
        bt = max(rt["compute_s"], rt["memory_s"], rt["collective_s"])
        out.append({
            "arch": r["arch"], "shape": r["shape"],
            "bound_before_s": f"{bb:.4f}", "bound_after_s": f"{bt:.4f}",
            "speedup": f"{bb / bt:.2f}x" if bt else "-",
            "dominant_after": rt["dominant"],
        })
    return out


METHODOLOGY = f"""## Methodology (roofline terms)

For each (arch × shape × mesh) cell, `repro_torch.launch.dryrun`:
1. builds `meta` stand-ins for the parameters, optimizer state, batch,
   caches and cross k/v at the global shapes, heads and experts padded to
   the mesh's tensor parallelism, with the reference's logical specs;
2. runs the step once on them, op by op, under a `TorchDispatchMode`
   counter (`repro_torch.roofline.count`): matrix products 2·M·N·K,
   elementwise ops one FLOP per output element, reductions and scatters
   one per input element; bytes are every op's operands plus outputs
   (no fusion); the hand-written kernels are priced by their `*_work`
   counts and never run;
3. derives the per-chip terms, assuming the step's work splits evenly
   over the chips: `compute = FLOPs / chips / {M.PEAK_FLOPS_BF16:.4g}`,
   `memory = bytes / chips / {M.HBM_BW:.4g}`, `collective = collective
   bytes / {M.LINK_BW:.4g}`, the collectives priced from the spec trees
   (`repro_torch/roofline/analysis.py` states the rule);
4. `MODEL_FLOPS` = 6·N_active·D (train), 2·N_active·D (prefill), decode
   adds analytic KV-read FLOPs; `useful_ratio` = MODEL_FLOPS per chip over
   counted FLOPs per chip.

Peaks: {M.CARD} at {M.POWER_LIMIT_W} W (published): {M.PEAK_FLOPS_BF16:.4g}
FLOP/s bf16 dense, {M.HBM_BW:.4g} B/s HBM3, {M.LINK_BW:.4g} B/s NVLink one
way. The argument bytes are exact per-device shard bytes (XLA's rule for
an uneven split); the temp bytes are the count's peak of live bytes split
evenly. No time below was measured on a device.
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--perf-dir", default="experiments/perf_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    tuned = load(args.perf_dir) if os.path.isdir(args.perf_dir) else []

    print("""# EXPERIMENTS (repro_torch)

```
PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
PYTHONPATH=src python -m repro_torch.launch.dryrun --all --perf --out experiments/perf_torch
PYTHONPATH=src python -m repro_torch.roofline.experiments_md
```
""")
    print(METHODOLOGY)
    print("\n## Dry-run — single pod (16×16, 256 chips)\n")
    print(dryrun_table(recs, "16x16"))
    print("\n## Dry-run — multi-pod (2×16×16, 512 chips)\n")
    print(dryrun_table(recs, "2x16x16"))
    print("\n## Roofline — BASELINE, single pod\n")
    print(roofline_table(recs, "16x16"))
    if tuned:
        print("\n## BASELINE against TUNED (single pod)\n")
        print(md_table(perf_compare(recs, tuned),
                       ["arch", "shape", "bound_before_s", "bound_after_s",
                        "speedup", "dominant_after"]))
    figs = (("Fig 5 — K sweep", agg_fig5(),
             ["dataset", "K", "algo", "rounds", "largest", "nstdev",
              "messages", "gain"]),
            ("Fig 6 — diameter sweep", agg_fig6(),
             ["remap_frac", "diameter(ecc)", "rounds", "largest", "nstdev",
              "messages", "gain", "disconnected%"]),
            ("Fig 7 — DFEP vs DFEP-C vs JaBeJa", agg_fig7(),
             ["dataset", "algo", "largest", "nstdev", "messages", "gain",
              "connected", "rounds"]))
    for title, rows, cols in figs:
        if rows:
            print(f"\n## {title} (experiments/bench)\n")
            print(md_table(rows, cols))


if __name__ == "__main__":
    main()
