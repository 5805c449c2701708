"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero with no "ok"
line):

1. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); build both CUDA kernels from ``src/repro_torch/
              csrc`` for sm_90a, one nvcc per source, in parallel.
3. main     — the paper's pipeline at the EC2 scale, through the user entry
              points on the card: ``load_dataset("dblp", scale=1.0)``,
              ``dfep.partition(k=16, max_rounds=4000, stall_rounds=64)``
              with seeded starts, ``compile_plan``, ``Engine``, then SSSP
              from vertex 0, WCC and PageRank (30 supersteps). SSSP and WCC
              must equal a scipy.sparse.csgraph oracle exactly; PageRank
              must agree with the engine's plain path on the card and with a
              float64 numpy oracle to the relative tolerances below. Both
              kernels' launch counters are zeroed before this phase and must
              have risen by its end.
2. kernels  — each kernel against its plain version on the main path's plan
              tensors (and segment_reduce also on a seeded plan-shaped input
              with deleted prefix slots, arrived vertices and a live append
              region), then timed: device time from CUDA-graph replays
              (``ms``, ``plain_ms``, ``library_ms``) and eager back-to-back
              calls with their host launch cost (``*_eager_ms``); prints
              one ``{"kernels": [...]}`` line.
4. cpu      — dblp at scale 0.03, K=16, the same starts: the port on the card
              and the port on the CPU give the same DFEP owner array and
              rounds, and the same SSSP result.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The H100 SXM's published peaks (NVIDIA data sheet) at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Tolerances, each with its reason:
#  * segment_reduce add: the kernel sums a segment in warp-shuffle order and
#    the append region with atomics; the plain version scatters with atomics
#    in another order. Hub segments hold thousands of float32 terms.
SEG_ADD_RTOL = 1e-4
#  * PageRank kernel path vs plain path on the card: the same sums in other
#    orders, 30 supersteps; ranks are ~3e-6, so the bound is relative.
PR_PLAIN_RTOL = 1e-4
#  * PageRank vs a float64 numpy oracle: float32 accumulation over 30 steps.
PR_ORACLE_RTOL = 1e-3
DBLP_SCALE, K, SEED = 1.0, 16, 0
CPU_CHECK_SCALE = 0.03


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, after the device has
    finished its work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back eager calls
    (CUDA events): device time, or the host's launch cost where that is
    longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one ``fn`` call in ms: ``iters`` calls captured
    in a CUDA graph, replayed ``replays`` times between CUDA events, so no
    host launch cost is in the number. ``fn`` is warmed first (lazy
    library loads, memoised plan indices) on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def peak_mib() -> float:
    return torch.cuda.max_memory_allocated() / 2**20


# ---------------------------------------------------------------------------
# Oracles (host, independent of the port)
# ---------------------------------------------------------------------------

def csr_of(g):
    from scipy.sparse import coo_matrix
    u, v = g.as_numpy()
    n = g.n_vertices
    a = coo_matrix((np.ones(len(u)), (u, v)), shape=(n, n)).tocsr()
    return (a + a.T).tocsr()


def sssp_oracle(csr, source: int) -> np.ndarray:
    from scipy.sparse.csgraph import shortest_path
    return shortest_path(csr, unweighted=True, indices=source).astype(np.float32)


def wcc_oracle(csr) -> np.ndarray:
    from scipy.sparse.csgraph import connected_components
    n_comp, labels = connected_components(csr, directed=False)
    mins = np.full(n_comp, csr.shape[0], np.int64)
    np.minimum.at(mins, labels, np.arange(csr.shape[0]))
    return mins[labels].astype(np.float32)


def pagerank_oracle(g, iters: int = 30, damping: float = 0.85) -> np.ndarray:
    u, v = g.as_numpy()
    n = g.n_vertices
    deg = np.maximum(np.bincount(np.concatenate([u, v]), minlength=n), 1)
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        c = rank / deg
        inflow = np.bincount(v, c[u], n) + np.bincount(u, c[v], n)
        rank = (1.0 - damping) / n + damping * inflow
    return rank


def max_rel(a: torch.Tensor, b) -> float:
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    return float(((a.double() - b).abs() / b.abs()).max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py "
            "drives the port on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    from repro_torch import cuda_build
    t0 = time.perf_counter()
    per_lib = cuda_build.build()
    log({"phase": "device", "card": card,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": time.perf_counter() - t0, "build_s_per_source": per_lib})
    for name in cuda_build.SIGNATURES:
        regs = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        log({"phase": "device", "ptxas": name, "info": regs})
    return card


def phase_main():
    from repro_torch.core import dfep, graph
    from repro_torch import engine as E
    from repro_torch.engine import kernels

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    g, t = wall(lambda: graph.load_dataset("dblp", scale=DBLP_SCALE,
                                           seed=SEED))
    log({"phase": "main.load_dataset", "wall_s": t, "n_vertices": g.n_vertices,
         "n_edges": g.n_edges, "e_pad": g.e_pad,
         "max_degree": int(g.degrees().max()), "peak_mib": peak_mib()})

    torch.cuda.reset_peak_memory_stats()
    (owner, info), t = wall(lambda: dfep.partition(
        g, k=K, seed=SEED, max_rounds=4000, stall_rounds=64))
    log({"phase": "main.dfep", "wall_s": t, "rounds": info["rounds"],
         "unsold_at_stop": info["unsold_at_stop"],
         "finalized": info["finalized"], "starts": info["starts"],
         "ms_per_round": 1e3 * t / max(info["rounds"], 1),
         "peak_mib": peak_mib()})
    own = owner.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    require(((own[em] >= 0) & (own[em] < K)).all() and (own[~em] == -2).all(),
            "DFEP owner array is not a valid K-partition")

    torch.cuda.reset_peak_memory_stats()
    plan, t = wall(lambda: E.compile_plan(g, owner, K))
    log({"phase": "main.compile_plan", "wall_s": t, "v_max": plan.v_max,
         "e_max": plan.e_max,
         "replication_factor": plan.replication_factor(),
         "exchange_volume": plan.exchange_volume, "peak_mib": peak_mib()})

    eng = E.Engine(plan)
    results = {}
    for name, run in (("sssp", lambda: E.engine_sssp(eng, 0)),
                      ("wcc", lambda: E.engine_wcc(eng)),
                      ("pagerank", lambda: E.engine_pagerank(
                          eng, g.degrees(), iters=30))):
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        r, t = wall(run)
        results[name] = r
        log({"phase": f"main.{name}", "wall_s": t, **r.row(),
             "launches": {k: kernels.LAUNCHES[k] - before[k]
                          for k in kernels.LAUNCHES},
             "peak_mib": peak_mib()})
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    csr = csr_of(g)
    sssp = results["sssp"].state.cpu().numpy()
    require(np.array_equal(sssp, sssp_oracle(csr, 0)),
            "SSSP differs from the scipy oracle")
    wcc = results["wcc"].state.cpu().numpy()
    require(np.array_equal(wcc, wcc_oracle(csr)),
            "WCC differs from the scipy oracle")
    require(all(results[n].converged for n in ("sssp", "wcc")),
            "SSSP/WCC did not converge")
    pr = results["pagerank"].state
    pr_plain, t = wall(lambda: E.engine_pagerank(
        E.Engine(plan, use_kernels=False), g.degrees(), iters=30))
    rel_plain = max_rel(pr, pr_plain.state)
    rel_oracle = max_rel(pr, pagerank_oracle(g))
    log({"phase": "main.check", "sssp_equal_oracle": True,
         "wcc_equal_oracle": True, "pagerank_max_rel_vs_plain": rel_plain,
         "pagerank_plain_wall_s": t, "pagerank_max_rel_vs_f64_oracle":
             rel_oracle, "launches": launches})
    require(rel_plain <= PR_PLAIN_RTOL, f"PageRank kernel vs plain path: "
            f"max rel {rel_plain} > {PR_PLAIN_RTOL}")
    require(rel_oracle <= PR_ORACLE_RTOL, f"PageRank vs float64 oracle: "
            f"max rel {rel_oracle} > {PR_ORACLE_RTOL}")
    return plan, launches


def _patched_like(plan, gen, arrivals: int = 32):
    """A seeded plan-shaped input, as the streaming patch path leaves a
    plan: ~5% of CSR prefix slots deleted; ``arrivals`` vertex slots past
    each partition's ``n_local`` made live (their ``last_slot`` is the
    identity pad slot); about half of the free append slots
    ``[csr_fill, e_max-1)`` live, each its own segment, with random
    targets among the old and the arrived vertices."""
    dev = plan.device
    slot = torch.arange(plan.e_max, device=dev)[None, :]
    fill = plan.csr_fill.long()[:, None]
    rnd = torch.rand(plan.emask.shape, generator=gen, device=dev)
    dele = (slot < fill) & plan.emask & (rnd < 0.05)
    region = (slot >= fill) & (slot < plan.e_max - 1) & (rnd < 0.5)
    n_live = (plan.n_local + arrivals).clamp(max=plan.v_max)
    vslot = torch.arange(plan.v_max, device=dev)[None, :]
    tgt = (torch.rand(plan.emask.shape, generator=gen, device=dev)
           * n_live[:, None]).to(torch.int32)
    return dataclasses.replace(
        plan, vmask=plan.vmask | (vslot < n_live[:, None]),
        emask=(plan.emask & ~dele) | region,
        seg_start=plan.seg_start | region,
        edge_tgt=torch.where(region, tgt, plan.edge_tgt))


def _seg_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for segment_reduce on this plan: each live message read
    once and combined once, the masks and per-target indices read once,
    each aggregate written once."""
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    live = int(plan.emask.sum())
    slot = torch.arange(plan.e_max, device=plan.device)[None, :]
    append_live = int((plan.emask & (slot >= plan.csr_fill[:, None])).sum())
    nbytes = (4 * f * live + 2 * ke + 5 * kv + 4 * plan.k
              + 4 * append_live + 4 * f * kv)
    return _bound(nbytes, f * live)


def _mu_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for the fused masked_update: private live slots read
    state, replicated live slots read their index and their vertex's glob
    row (each distinct row once), both masks read and every slot written."""
    kv = plan.k * plan.v_max
    rep = plan.vmask & plan.replicated
    private = int((plan.vmask & ~plan.replicated).sum())
    n_rep = int(rep.sum())
    rows = int(torch.unique(plan.local2global[rep]).numel())
    nbytes = 4 * f * private + 4 * n_rep + 4 * f * rows + 2 * kv + 4 * f * kv
    return _bound(nbytes, 0)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(plan, launches):
    from repro_torch.engine import kernels as Kn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = plan.device
    rows = torch.arange(plan.k, device=dev)[:, None] * plan.v_max
    flat_tgt = (rows + plan.edge_tgt.long()).reshape(-1)

    def check_seg(p, msgs, combine):
        got = Kn.segment_reduce(p, msgs, combine)
        want = Kn.segment_reduce_ref(p, msgs, combine)
        torch.cuda.synchronize()
        require(torch.equal(torch.isinf(got), torch.isinf(want)),
                f"segment_reduce {combine}: infinities differ")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        rel = float(((got[fin] - want[fin]).abs()
                     / want[fin].abs().clamp(min=1e-30)).max()) \
            if fin.any() else 0.0
        if combine == "add":
            require(rel <= SEG_ADD_RTOL, f"segment_reduce add: max rel {rel}")
        else:
            require(torch.equal(got, want), f"segment_reduce {combine} is "
                    "not exact")
        return err, rel

    # messages at the main path's shape: SSSP-like, with unreached (+inf)
    # slots; non-negative finite values for add and max
    dist = torch.rand(plan.emask.shape, generator=gen, device=dev) * 30
    dist = torch.where(torch.rand(plan.emask.shape, generator=gen,
                                  device=dev) < 0.2, float("inf"), dist)
    finite = torch.where(torch.isinf(dist), 1.0, dist) / 30
    patched = _patched_like(plan, gen)
    errs, rels = {}, {}
    for name, p in (("plan", plan), ("patched", patched)):
        for combine, msgs in (("min", dist), ("max", finite),
                              ("add", finite)):
            key = f"{name}.{combine}"
            errs[key], rels[key] = check_seg(p, msgs, combine)
    log({"phase": "kernels.segment_reduce.check", "max_abs_err": errs,
         "max_rel_err": rels,
         "append_live_slots": int((patched.emask & ~plan.emask).sum()),
         "arrived_vertices": int((patched.vmask & ~plan.vmask).sum())})

    # replica states at the main path's shape, some unreached (+inf)
    state = torch.rand((plan.k, plan.v_max), generator=gen, device=dev) * 30
    state = torch.where(torch.rand(state.shape, generator=gen, device=dev)
                        < 0.2, float("inf"), state)
    glob = torch.rand(plan.n_vertices, generator=gen, device=dev) * 30
    mu_args = (state, glob, plan.local2global, plan.vmask, plan.replicated)
    mu_err = 0.0
    for combine in ("min", "add"):
        got = Kn.masked_update(*mu_args, combine)
        want = Kn.masked_update_ref(*mu_args, combine)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"masked_update {combine} not exact")
        fin = torch.isfinite(want)
        mu_err = max(mu_err, float((got[fin] - want[fin]).abs().max()))
    log({"phase": "kernels.masked_update.check", "exact": True,
         "max_abs_err": mu_err})

    # timing at the main path's shapes
    masked = {c: torch.where(plan.emask, m, Kn._IDENTITY[c]).reshape(-1)
              for c, m in (("min", dist), ("add", finite))}
    ident = {c: torch.full((plan.k * plan.v_max,), Kn._IDENTITY[c],
                           device=dev) for c in masked}
    def times(**fns):
        """Device ms (CUDA graph) and eager ms (with host launch cost)."""
        out = {f"{k}_ms": device_ms(f) for k, f in fns.items()}
        out.update({f"{k}_eager_ms": eager_ms(f) for k, f in fns.items()})
        return out

    seg_t = {}
    for c in ("min", "add"):
        m = dist if c == "min" else finite
        seg_t[c] = times(
            kernel=lambda: Kn.segment_reduce(plan, m, c),
            plain=lambda: Kn.segment_reduce_ref(plan, m, c),
            library=lambda: torch.scatter_reduce(
                ident[c], 0, flat_tgt, masked[c], Kn._SCATTER[c]))
    mu_t = times(kernel=lambda: Kn.masked_update(*mu_args, "min"),
                 plain=lambda: Kn.masked_update_ref(*mu_args, "min"))
    log({"phase": "kernels.timing", "segment_reduce": seg_t,
         "masked_update": mu_t})

    seg_bound, seg_by = _seg_bound(plan)
    mu_bound, mu_by = _mu_bound(plan)
    return {"kernels": [
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/engine/kernels.py:82",
         "launches": launches["segment_reduce"],
         "max_abs_err": errs["plan.min"],
         "ms": seg_t["min"]["kernel_ms"],
         "plain_ms": seg_t["min"]["plain_ms"],
         "bound_ms": seg_bound, "bound_by": seg_by,
         "library_ms": seg_t["min"]["library_ms"],
         "combine": "min", "shape": [plan.k, plan.e_max]},
        {"name": "masked_update", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_update.cu",
         "replaces": "src/repro/engine/kernels.py:394",
         "launches": launches["masked_update"], "max_abs_err": mu_err,
         "ms": mu_t["kernel_ms"], "plain_ms": mu_t["plain_ms"],
         "bound_ms": mu_bound, "bound_by": mu_by, "library_ms": None,
         "combine": "min", "shape": [plan.k, plan.v_max]},
    ]}


def phase_cpu_equal():
    from repro_torch.core import dfep, graph
    from repro_torch import engine as E

    out, starts = {}, None
    for dev in ("cuda", "cpu"):
        g = graph.load_dataset("dblp", scale=CPU_CHECK_SCALE, seed=SEED,
                               device=dev)
        if starts is None:   # the same start vertices on both devices
            starts = dfep.draw_starts(g.n_vertices, K, SEED)
        t0 = time.perf_counter()
        owner, info = dfep.partition(g, k=K, starts=starts, max_rounds=4000,
                                     stall_rounds=64, device=dev)
        plan = E.compile_plan(g, owner, K, device=dev)
        r = E.engine_sssp(E.Engine(plan), 0)
        out[dev] = (owner.cpu(), info["rounds"], r.state.cpu(), r.row(),
                    time.perf_counter() - t0)
    require(torch.equal(out["cuda"][0], out["cpu"][0]),
            "DFEP owner differs between card and CPU")
    require(out["cuda"][1] == out["cpu"][1], "DFEP rounds differ")
    require(torch.equal(out["cuda"][2], out["cpu"][2]), "SSSP differs")
    require(out["cuda"][3] == out["cpu"][3], "SSSP counters differ")
    log({"phase": "cpu_equal", "scale": CPU_CHECK_SCALE, "rounds":
         out["cuda"][1], "sssp": out["cuda"][3], "wall_s_cuda":
         out["cuda"][4], "wall_s_cpu": out["cpu"][4]})


def main() -> int:
    card = phase_device()
    plan, launches = phase_main()
    kernel_line = phase_kernels(plan, launches)
    phase_cpu_equal()
    print(card, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
