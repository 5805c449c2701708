"""Profile the PyTorch DFEP round loop on one GPU.

    python3 tools/profile_dfep.py

Builds dblp at scale 1.0 on the card, runs three warm-up rounds with K=16,
then ten rounds under ``torch.profiler``, and prints the card's name and
power limit, the mean round time (CUDA events) and the ops that take the
most device time. Then it times a whole
``dfep.partition(k=16, max_rounds=4000, stall_rounds=64)``, the settings
``chip_smoke.py`` drives.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


SCALE, K, ROUNDS = 1.0, 16, 10


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.core import dfep, graph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    g = graph.load_dataset("dblp", scale=SCALE, seed=0)
    slots = dfep.build_slots(g)
    cfg = dfep.DfepConfig(k=K, max_rounds=4000, stall_rounds=64)
    st = dfep.init_state(g, cfg, dfep.draw_starts(g.n_vertices, K, 0))
    for _ in range(3):
        st = dfep._round(g, slots, cfg, st)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(ROUNDS):
            st = dfep._round(g, slots, cfg, st)
            bool((st.owner == dfep.FREE).any())   # the loop's one host read
        end.record()
        torch.cuda.synchronize()
    print(json.dumps({"scale": SCALE, "edges": g.n_edges, "k": K,
                      "ms_per_round": start.elapsed_time(end) / ROUNDS}))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = dfep.partition(g, k=K, seed=0, max_rounds=4000,
                             stall_rounds=64)
    torch.cuda.synchronize()
    print(json.dumps({"full_partition_s": time.perf_counter() - t0,
                      "rounds": info["rounds"],
                      "unsold_at_stop": info["unsold_at_stop"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
