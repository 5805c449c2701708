"""A copy of the benchmark's data at a size a CPU test run holds.

:func:`make_root` writes a checkout-like directory: ``BENCHMARK.json`` with
the real cells, metrics and configurations, each configuration cut to a
few hundred vertices, the traffic mixes shortened, and the real
metric readers. The harness's code is the real one; only the data is cut.
"""
from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
#: scale and K of each dataset here: a few hundred vertices, at which the
#: bfloat16 control already sells other edges
CUTS = {"dblp": (0.0005, 4)}


def make_root(tmp: Path) -> Path:
    bench = tmp / "perfbench"
    bench.mkdir(parents=True)
    for sub in ("metrics", "traffic", "configs"):
        shutil.copytree(REPO / "perfbench" / sub, bench / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        scale, k = CUTS[cfg["dataset"]]
        cfg.update(scale=scale, k=k)
        path.write_text(json.dumps(cfg))
    lanes = bench / "traffic" / "sssp-lanes.json"
    t = json.loads(lanes.read_text())
    t.update(clients=8, tenants=2, warmup_s=0.05, trace_s=0.1)
    t["server"]["buckets"] = [1, 2, 4]
    t["check"] = {"share": 1.0, "max": 64}
    lanes.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@contextlib.contextmanager
def one_thread():
    """Tiny tensors run fastest on one CPU thread, and the suite's workers
    share the machine; the setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())
