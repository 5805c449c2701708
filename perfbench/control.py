"""The control of ``correct``: the reference put in the program's place and
computed one precision lower (bfloat16 for the configuration's float32),
held to the same comparison, must come out not correct.

``python3 perfbench/control.py --workload <cell> --seeds <n> <n> ...``
prints one JSON line a seed with the compared numbers of the control, at
the cell's own size: for a serving cell, as many queries as a run checks,
drawn from the cell's clients; for a partitioning cell, the window's first
partition. ``perfbench/tests/test_perfbench_control.py`` runs the same at a
size a CPU test run holds.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def control(root: Path, workload: str, seed: int, device) -> dict:
    """The control's compared numbers for ``workload`` at ``seed``."""
    from perfbench import checks, drivers, harness
    from perfbench.reference import graphgen
    cell = harness.resolve(harness.load_spec(root), root, workload)
    cfg, traffic = cell["config"], cell["traffic"]
    edges = graphgen.make(cfg["graph"], cfg["scale"], seed)
    low = torch.bfloat16
    if traffic["driver"] == "closed_loop":
        loop = drivers.ClosedLoop(traffic, edges.n_vertices, seed)
        queries = []
        while len(queries) < traffic["check"]["max"]:
            for c in loop.clients:
                _, prog, source, _ = loop.request(c)
                queries.append((prog, source))
        queries = queries[:traffic["check"]["max"]]
        samples = []
        for prog in sorted({p for p, _ in queries}):
            srcs = [s for p, s in queries if p == prog]
            got = checks.reference(prog).solve(
                edges, np.array(srcs), dtype=low, device=device).cpu().numpy()
            samples += [(prog, s, v) for s, v in zip(srcs, got)]
        checked, wrong = checks.wrong_answers(edges, samples, device)
        return {"wrong_answers": wrong, "checked": checked}
    k = cfg["k"]
    starts = drivers.draw_starts(drivers.rng(seed, drivers.PARTS),
                                 edges.n_vertices, k)
    d = cfg["dfep"]
    owner, rounds = checks.ref_dfep.partition(
        edges, k, starts, cap=d["cap"], max_rounds=d["max_rounds"],
        stall_rounds=d["stall_rounds"], dtype=low, device=device)
    mismatch, gap = checks.partition_gaps(edges, k, starts, owner, rounds,
                                          d, device)
    return {"owner_mismatch": mismatch, "rounds_gap": gap}


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench/control.py: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = control(ROOT, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main(sys.argv[1:]))
