"""Time the served stream of ``chip_smoke.py``'s serve phase with and
without a cost ledger on one GPU, and show where a difference comes from.

    python3 tools/probe_ledger.py [--turns N]

On the main path's plan (dblp 1.0 partitioned by DFEP, K = 16, 4000
rounds, as ``chip_smoke.py``'s main phase), ``chip_smoke.SERVE_REQUESTS``
seeded requests (``chip_smoke._serve_requests``, the serve phase's
stream) are served by a fresh ``GraphServer`` of each variant, in turns
(each variant once untimed first):

  plain   no ledger;
  ledger  a ``CostLedger``: every batch priced and posted, admission,
          flush order and in-flight completion weighted by cost;
  post    a ledger whose shares the scheduler never sees (every batch
          priced and posted; FIFO flush order, full pipelining);
  fifo    a ledger with the flush order back to FIFO (the in-flight
          completion rule still on).

Each serve logs its wall s and q/s, ``device_time_s``, its batches in
order (program@bucket) and, per batch, the host ms of its dispatch and of
its completion; a summary line gives each variant's median q/s and the
batch orders that differ from the plain server's. One JSON object a line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def _server_class(G, batches: list):
    class Timed(G.GraphServer):
        """The server, with each batch's dispatch and completion timed."""
        def _dispatch_batch(self, batch, buffer):
            t = time.perf_counter()
            fl = G.GraphServer._dispatch_batch(self, batch, buffer)
            batches.append({"batch": f"{batch.requests[0].kind}"
                                     f"@{fl.bucket}",
                            "dispatch_ms": 1e3 * (time.perf_counter() - t)})
            fl_index[id(fl)] = len(batches) - 1
            return fl

        def _complete(self, fl):
            t = time.perf_counter()
            out = G.GraphServer._complete(self, fl)
            batches[fl_index.pop(id(fl))]["complete_ms"] = \
                1e3 * (time.perf_counter() - t)
            return out

    fl_index: dict = {}
    return Timed


def _serve(variant: str, G, obs, E, plan, g, reqs) -> dict:
    batches: list = []
    cls = _server_class(G, batches)
    if variant == "plain":
        srv = cls(E.Engine(plan), g)
    else:
        srv = cls(E.Engine(plan), g, ledger=obs.CostLedger())
        if variant == "post":
            srv._ledger_shares = lambda: {}
        elif variant == "fifo":
            srv._batcher.cost_of = None
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    C.require(all(r.error is None for r in out), f"{variant}: results")
    row = {"variant": variant, "wall_s": wall, "qps": len(reqs) / wall,
           "device_time_s": srv.metrics.device_time_s,
           "order": [b["batch"] for b in batches],
           "dispatch_ms": [b["dispatch_ms"] for b in batches],
           "complete_ms": [b.get("complete_ms") for b in batches]}
    srv.close()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch import engine as E
    from repro_torch import gserve as G
    from repro_torch import obs
    from repro_torch.core import dfep, graph

    print(json.dumps({"card": C.phase_device()}), flush=True)
    g = graph.load_dataset("dblp", scale=C.DBLP_SCALE, seed=C.SEED)
    owner, _ = dfep.partition(g, k=C.K, seed=C.SEED, max_rounds=4000,
                              stall_rounds=64)
    plan = E.compile_plan(g, owner, C.K)
    n = g.n_vertices
    rng = np.random.default_rng(C.SEED)
    p = rng.random(n)
    planes = {"x": E.ChannelValue(rng.normal(size=(n, E.GCN_F_IN))),
              "w": E.ChannelValue(rng.normal(size=(E.GCN_F_IN,
                                                   E.GCN_F_OUT))),
              "p": E.ChannelValue(p / p.sum()),
              "labels": E.ChannelValue(rng.permutation(n))}
    reqs = C._serve_requests(G, rng, n, planes, C.SERVE_REQUESTS)
    variants = ("plain", "ledger", "post", "fifo")
    for v in variants:                      # warm-up, untimed
        _serve(v, G, obs, E, plan, g, reqs)
    rows = {v: [] for v in variants}
    for turn in range(args.turns):
        order = variants if turn % 2 == 0 else variants[::-1]
        for v in order:
            row = _serve(v, G, obs, E, plan, g, reqs)
            rows[v].append(row)
            print(json.dumps({"turn": turn, **row}), flush=True)
    plain_order = rows["plain"][0]["order"]
    print(json.dumps({"summary": {
        v: {"qps_median": float(np.median([r["qps"] for r in rows[v]])),
            "qps": [r["qps"] for r in rows[v]],
            "device_time_s": [r["device_time_s"] for r in rows[v]],
            "order_differs": [r["order"] != plain_order for r in rows[v]]}
        for v in variants}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
