"""Render the dry run's tables from the per-cell JSON records that
``repro_torch.launch.dryrun`` writes (the counterpart of
``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir experiments/dryrun_torch]

The roofline fraction divides the useful compute time (MODEL_FLOPS per
chip at the card's bf16 peak, ``launch/mesh.py``) by the binding term.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..launch import mesh as M


def load(dir_: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(recs: list[dict], mesh: str) -> str:
    lines = ["| arch | shape | status | params | per-dev bytes (arg+tmp) | "
             "count s |",
             "|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "ok":
            ma = r.get("memory_analysis", {})
            dev_bytes = (ma.get("argument_size_in_bytes", 0)
                         + ma.get("temp_size_in_bytes", 0))
            lines.append(
                f"| {r['arch']} | {r['shape']} | ok | "
                f"{r.get('params', 0)/1e9:.2f}B | {fmt_bytes(dev_bytes)} | "
                f"{r.get('count_s', '?')} |")
        elif r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skipped | — | — | — |")
        else:
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | — | — | — |")
    return "\n".join(lines)


def _frac(r: dict, peak_flops: float) -> float:
    """Useful-compute time over the binding term."""
    ro = r["roofline"]
    bound = max(ro["compute_s"], ro["memory_s"], ro["collective_s"])
    useful_s = (ro["model_flops_global"] / r["chips"]) / peak_flops
    return useful_s / bound if bound else 0.0


def roofline_table(recs: list[dict], mesh: str = "16x16",
                   peak_flops: float = M.PEAK_FLOPS_BF16) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPS | useful ratio | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.4f} | "
            f"{ro['memory_s']:.4f} | {ro['collective_s']:.4f} | "
            f"{ro['dominant']} | {ro['model_flops_global']:.2e} | "
            f"{ro['useful_ratio']:.2f} | {_frac(r, peak_flops):.3f} |")
    return "\n".join(lines)


def pick_hillclimb(recs: list[dict]) -> list[dict]:
    """Worst roofline fraction, most collective-bound, most MoE/EP-relevant."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"]
    picks: list[dict] = []

    def add(r):
        if all(p["arch"] != r["arch"] or p["shape"] != r["shape"]
               for p in picks):
            picks.append(r)

    add(max(ok, key=lambda r: r["roofline"]["collective_s"]
            / max(r["roofline"]["compute_s"], 1e-9)))
    for r in sorted(ok, key=lambda r: _frac(r, M.PEAK_FLOPS_BF16)):
        if len(picks) < 2:
            add(r)
    for r in sorted((r for r in ok if "moe" in r["arch"]
                     or "deepseek" in r["arch"] or "jamba" in r["arch"]),
                    key=lambda r: -r["roofline"]["model_flops_global"]):
        if len(picks) < 3:
            add(r)
    return picks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run (16x16, 256 chips)\n")
    print(dryrun_table(recs, "16x16"))
    print("\n## Dry-run (2x16x16, 512 chips)\n")
    print(dryrun_table(recs, "2x16x16"))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(recs))
    print("\n## Hillclimb candidates\n")
    for r in pick_hillclimb(recs):
        print(f"- {r['arch']} × {r['shape']} (dominant: "
              f"{r['roofline']['dominant']})")


if __name__ == "__main__":
    main()
