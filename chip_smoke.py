"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

Phases, in the order they run (any failure raises, so the process exits
non-zero with no "ok" line):

1. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); build the three CUDA kernels from
              ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, in
              parallel.
2. main     — the paper's pipeline at the EC2 scale, through the user entry
              points on the card: ``load_dataset("dblp", scale=1.0)``,
              ``dfep.partition(k=16, max_rounds=4000, stall_rounds=64)``
              with seeded starts, ``compile_plan``, ``Engine``, then SSSP
              from vertex 0, WCC and PageRank (30 supersteps). SSSP and WCC
              must equal a scipy.sparse.csgraph oracle exactly; PageRank
              must agree with the engine's plain path on the card and with a
              float64 numpy oracle to the relative tolerances below. The
              launch counters are zeroed before this phase, and both of its
              kernels (segment_reduce, masked_update) must have risen by its
              end.
3. gnn      — the second path on the main phase's plan, through the user
              entry points: ``engine_gcn_layer`` (x [V, 8], weight [8, 4]),
              ``engine_kge_score`` (entity [V, 8], relation [e_pad, 8]),
              ``engine_weighted_sssp(0)``, ``engine_bfs(0)``,
              ``engine_label_propagation`` and
              ``engine_personalized_pagerank`` (30 supersteps), inputs
              seeded from numpy. The counters are zeroed before it; gspmm
              must rise during gcn_layer and during kge_score, and every
              kernel of the path by its end. wsssp, BFS and labelprop must
              equal host numpy/scipy oracles bit for bit; PPR must agree with
              the plain path on the card and with a float64 numpy oracle
              element by element, and gcn_layer and kge_score to a bound
              relative to their largest value (tolerances below).
4. kernels  — each kernel against its plain version on the main path's plan
              tensors and on a seeded plan-shaped input with deleted prefix
              slots, arrived vertices and a live append region (gspmm at
              F = 1, 8 and 128, add/max/mean, scalar and per-feature
              weights; masked_update scalar and at the GNN state's F=8),
              then timed: device time from CUDA-graph replays (``ms``,
              ``plain_ms``, ``library_ms``) and eager back-to-back calls
              with their host launch cost (``*_eager_ms``), gspmm also with
              only its largest hub run live and with no live slot (the
              difference is the hub run's time); prints one
              ``{"kernels": [...]}`` line.
5. cpu      — dblp at scale 0.03, K=16, the same starts: the port on the card
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
#  * gspmm add/mean vs plain, on non-negative features and weights: the
#    kernel sums a run in slot order, or hub runs as block partials combined
#    by atomics; the plain version scatters with atomics in another order.
#    Hub runs hold ~10^5 float32 terms.
GSPMM_ADD_RTOL = 1e-4
#    PPR is held element by element to PR_PLAIN_RTOL / PR_ORACLE_RTOL, as
#    PageRank is: its ranks are positive and ~3e-6 on average, so a bound
#    relative to the largest rank would pass a result wrong almost
#    everywhere.
#  * gcn_layer and kge_score, kernel path vs plain path on the card: the
#    same float32 sums in other orders; a bound relative to the largest
#    value, since their outputs change sign and cancel (an elementwise
#    relative bound is undefined near 0).
GNN_PLAIN_REL = 1e-4
#  * the same vs float64 numpy oracles: float32 accumulation (KGE's hub
#    sums run over ~10^5 unnormalised terms, where absolute bounds drift).
GNN_ORACLE_REL = 1e-3
DBLP_SCALE, K, SEED = 1.0, 16, 0
CPU_CHECK_SCALE = 0.03
#: The kernels each path must launch.
MAIN_KERNELS = ("segment_reduce", "masked_update")
GNN_KERNELS = ("gspmm", "segment_reduce", "masked_update")
#: gspmm widths timed: the GNN programs' (8) and fig_gnn.py's widest (128).
GSPMM_WIDTHS = (8, 128)
#: Interleaved repeats of the largest hub run's timing (its spread is the
#: run-to-run noise of a difference of two device times).
HUB_REPEATS = 3


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


def pagerank_oracle(g, iters: int = 30, damping: float = 0.85,
                    personalization=None) -> np.ndarray:
    """Float64 PageRank; with ``personalization`` p, personalized PageRank
    (``rank <- (1-d) p + d inflow``, starting from p)."""
    u, v = g.as_numpy()
    n = g.n_vertices
    deg = np.maximum(np.bincount(np.concatenate([u, v]), minlength=n), 1)
    tele = np.full(n, 1.0 / n) if personalization is None \
        else np.asarray(personalization, np.float64)
    rank = tele.copy()
    for _ in range(iters):
        c = rank / deg
        inflow = np.bincount(v, c[u], n) + np.bincount(u, c[v], n)
        rank = (1.0 - damping) * tele + damping * inflow
    return rank


def wsssp_oracle(g, source: int, weights: np.ndarray) -> np.ndarray:
    """Weighted shortest paths as a float32 min-plus fixpoint: every
    relaxation is ``min(d[t], f32(d[s] + w))``, the engine's operation, so
    the fixpoint is bit-equal to it (the logic of the reference's
    ``reference_weighted_sssp``; the per-target min is a ``reduceat`` over
    target-sorted half-edges)."""
    u, v = g.as_numpy()
    src, dst = np.concatenate([u, v]), np.concatenate([v, u])
    w = np.concatenate([weights, weights]).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
    tgt = dst[starts]
    dist = np.full(g.n_vertices, np.inf, np.float32)
    dist[source] = 0.0
    for _ in range(g.n_vertices):
        best = np.minimum.reduceat((dist[src] + w).astype(np.float32), starts)
        new = dist.copy()
        new[tgt] = np.minimum(new[tgt], best)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def labelprop_oracle(csr, labels: np.ndarray) -> np.ndarray:
    """Every vertex takes the smallest label of its component."""
    from scipy.sparse.csgraph import connected_components
    n_comp, comp = connected_components(csr, directed=False)
    mins = np.full(n_comp, np.inf, np.float32)
    np.minimum.at(mins, comp, labels)
    return mins[comp]


def gcn_oracle(g, x, weight, ew) -> np.ndarray:
    """``(D^-1/2 A_w D^-1/2 X) W`` in float64 (``reference_gcn_layer``'s
    formula: A_w symmetric with the content-hash weights, no self-loops,
    degrees clamped at 1)."""
    from scipy.sparse import coo_matrix
    u, v = g.as_numpy()
    n = g.n_vertices
    deg = np.maximum(np.bincount(np.concatenate([u, v]), minlength=n), 1)
    inv = 1.0 / np.sqrt(deg.astype(np.float64))
    a = coo_matrix((ew.astype(np.float64), (v, u)), shape=(n, n)).tocsr()
    agg = (a + a.T) @ (x.astype(np.float64) * inv[:, None])
    return (agg * inv[:, None]) @ weight.astype(np.float64)


def kge_oracle(g, entity, relation) -> np.ndarray:
    """DistMult mass per vertex in float64 (``reference_kge_score``'s
    formula): each live edge e = (u, v) scores sum_f ent_u·rel_e·ent_v onto
    both endpoints; relation rows are graph edge slots."""
    slots = np.flatnonzero(g.edge_mask.cpu().numpy())
    u = g.src.cpu().numpy()[slots]
    v = g.dst.cpu().numpy()[slots]
    ent = entity.astype(np.float64)
    score = np.sum(ent[u] * relation[slots].astype(np.float64) * ent[v], 1)
    n = g.n_vertices
    return np.bincount(u, score, n) + np.bincount(v, score, n)


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
    for name in MAIN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")

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
    return g, plan, launches


def phase_gnn(g, plan):
    """The GNN path and the remaining programs on the main phase's plan."""
    from repro_torch import engine as E
    from repro_torch.core.graph import edge_weights
    from repro_torch.engine import kernels

    rng = np.random.default_rng(SEED)
    n = g.n_vertices
    x = rng.normal(size=(n, E.GCN_F_IN)).astype(np.float32)
    weight = rng.normal(size=(E.GCN_F_IN, E.GCN_F_OUT)).astype(np.float32)
    entity = rng.normal(size=(n, E.KGE_F)).astype(np.float32)
    relation = rng.normal(size=(g.e_pad, E.KGE_F)).astype(np.float32)
    labels = rng.permutation(n).astype(np.float32)
    p = rng.random(n)
    p = (p / p.sum()).astype(np.float32)
    deg = g.degrees()
    runs = {
        "gcn_layer": lambda e: E.engine_gcn_layer(e, deg, x, weight),
        "kge_score": lambda e: E.engine_kge_score(e, entity, relation),
        "wsssp": lambda e: E.engine_weighted_sssp(e, 0),
        "bfs": lambda e: E.engine_bfs(e, 0),
        "labelprop": lambda e: E.engine_label_propagation(e, labels),
        "ppr": lambda e: E.engine_personalized_pagerank(e, deg, p, 30),
    }
    eng = E.Engine(plan)
    results = {}
    kernels.reset_launches()
    for name, run in runs.items():
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        r, t = wall(lambda: run(eng))
        results[name] = r
        got = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        log({"phase": f"gnn.{name}", "wall_s": t, **r.row(),
             "launches": got, "peak_mib": peak_mib()})
        if name in ("gcn_layer", "kge_score"):
            require(got["gspmm"] > 0, f"{name} did not launch gspmm")
    launches = dict(kernels.LAUNCHES)
    for name in GNN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the gnn path")
    # the first calls above include one-off set-up (library loads, cuBLAS
    # for gcn_layer's matmul); a second call of each is the warm query
    log({"phase": "gnn.warm", "wall_s": {name: wall(lambda: run(eng))[1]
                                         for name, run in runs.items()}})

    plain_eng = E.Engine(plan, use_kernels=False)
    plain, plain_s = {}, {}
    for name in ("gcn_layer", "kge_score", "ppr"):
        r, plain_s[name] = wall(lambda: runs[name](plain_eng))
        plain[name] = r.state

    t0 = time.perf_counter()
    csr = csr_of(g)
    u, v = g.as_numpy()
    ew = edge_weights(u, v)
    bfs = sssp_oracle(csr, 0)
    oracle = {
        "wsssp": wsssp_oracle(g, 0, ew),
        "bfs": np.where(np.isinf(bfs), np.float32(-1.0), bfs),
        "labelprop": labelprop_oracle(csr, labels),
        "ppr": pagerank_oracle(g, 30, personalization=p),
        "gcn_layer": gcn_oracle(g, x, weight, ew),
        "kge_score": kge_oracle(g, entity, relation),
    }
    oracle_s = time.perf_counter() - t0
    for name in ("wsssp", "bfs", "labelprop"):
        got = results[name].state.cpu().numpy()
        require(got.dtype == np.float32 and got.shape == (n,),
                f"{name}: result is {got.dtype} {got.shape}")
        require(np.array_equal(got, oracle[name]),
                f"{name} differs from its host oracle")
        require(results[name].converged, f"{name} did not converge")
    check = {}
    for name in ("ppr", "gcn_layer", "kge_score"):
        got = results[name].state
        want = torch.from_numpy(oracle[name]).to(got.device)
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"{name}: result {tuple(got.shape)} is not finite and of "
                f"shape {tuple(want.shape)}")
        if name == "ppr":
            rel_p, rel_o = max_rel(got, plain[name]), max_rel(got, want)
            check[name] = {"max_rel_vs_plain": rel_p,
                           "max_rel_vs_f64_oracle": rel_o,
                           "plain_wall_s": plain_s[name]}
            require(rel_p <= PR_PLAIN_RTOL, f"ppr kernel vs plain path: max "
                    f"rel {rel_p} > {PR_PLAIN_RTOL}")
            require(rel_o <= PR_ORACLE_RTOL, f"ppr vs float64 oracle: max "
                    f"rel {rel_o} > {PR_ORACLE_RTOL}")
            continue
        scale_p = float(plain[name].abs().max())
        err_p = float((got - plain[name]).abs().max())
        scale_o = float(want.abs().max())
        err_o = float((got.double() - want).abs().max())
        check[name] = {"max_abs_vs_plain": err_p, "max_abs_plain": scale_p,
                       "max_abs_vs_f64_oracle": err_o,
                       "max_abs_oracle": scale_o,
                       "plain_wall_s": plain_s[name]}
        require(err_p <= GNN_PLAIN_REL * scale_p, f"{name} kernel vs plain "
                f"path: max abs {err_p} > {GNN_PLAIN_REL} x {scale_p}")
        require(err_o <= GNN_ORACLE_REL * scale_o, f"{name} vs float64 "
                f"oracle: max abs {err_o} > {GNN_ORACLE_REL} x {scale_o}")
    log({"phase": "gnn.check",
         "bit_equal_oracle": ["wsssp", "bfs", "labelprop"],
         "oracle_s": oracle_s, **check, "launches": launches})
    return launches


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


def _gspmm_bound(plan, f: int) -> tuple[float, str]:
    """Least time for gspmm with scalar weights on this plan: per live
    half-edge its neighbour index and its weight; per slot the two masks;
    per target ``last_slot`` and ``vmask``; per live append slot its target;
    each distinct live feature row read once; each output row written once.
    Operations: a multiply and a combine per feature per live half-edge."""
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    live = int(plan.emask.sum())
    slot = torch.arange(plan.e_max, device=plan.device)[None, :]
    append_live = int((plan.emask & (slot >= plan.csr_fill[:, None])).sum())
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    rows = int(torch.unique((base + plan.edge_nbr.long())[plan.emask]).numel())
    nbytes = (8 * live + 2 * ke + 5 * kv + 4 * plan.k + 4 * append_live
              + 4 * f * rows + 4 * f * kv)
    return _bound(nbytes, 2 * f * live)


def _spmm_matrix(plan):
    """The yardstick's operand: the live half-edges as one block-diagonal
    CSR matrix [K·Vmax, K·Vmax] (row: target, column: neighbour, value:
    ``edge_w``), so ``torch.sparse.mm(a, feats.view(K·Vmax, F))`` computes
    gspmm's add on a fresh plan."""
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    idx = torch.stack([(base + plan.edge_tgt.long())[plan.emask],
                       (base + plan.edge_nbr.long())[plan.emask]])
    n = plan.k * plan.v_max
    return torch.sparse_coo_tensor(idx, plan.edge_w[plan.emask], (n, n),
                                   check_invariants=False) \
        .coalesce().to_sparse_csr()


def _hub_split(plan):
    """(the target with the longest run, the plan with only that run live,
    the plan with no live slot)."""
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    tgt = base + plan.edge_tgt.long()
    runs = torch.zeros(plan.k * plan.v_max, device=plan.device)
    runs.index_add_(0, tgt[plan.emask],
                    torch.ones(int(plan.emask.sum()), device=plan.device))
    hub = int(runs.argmax())
    mask = plan.emask & (tgt == hub)
    return ({"target": hub, "partition": hub // plan.v_max,
             "run_slots": int(runs[hub])},
            dataclasses.replace(plan, emask=mask),
            dataclasses.replace(plan, emask=torch.zeros_like(mask)))


def _gspmm_checks(Kn, plan, patched, gen):
    """gspmm against gspmm_ref: both plans, F = 1 (rank-2 feats), 8, 128,
    scalar and per-feature weights, add/max/mean. max is exact; add and mean
    within GSPMM_ADD_RTOL on non-negative inputs."""
    dev = plan.device
    errs, rels = {}, {}
    for f in (1,) + GSPMM_WIDTHS:
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        if f == 1:
            feats = feats[:, :, 0]
        wide = torch.rand(tuple(plan.emask.shape) + (f,), generator=gen,
                          device=dev)
        for pname, p in (("plan", plan), ("patched", patched)):
            for wname, w in (("scalar", p.edge_w), ("feature", wide)):
                for combine in ("add", "max", "mean"):
                    key = f"{pname}.f{f}.{wname}.{combine}"
                    got = Kn.gspmm(p, feats, w, combine)
                    want = Kn.gspmm_ref(p, feats, w, combine)
                    torch.cuda.synchronize()
                    require(got.shape == (p.k, p.v_max, f),
                            f"gspmm {key}: shape {tuple(got.shape)}")
                    if combine == "max":
                        require(torch.equal(got, want),
                                f"gspmm {key} is not exact")
                    fin = torch.isfinite(want)
                    diff = (got[fin] - want[fin]).abs()
                    errs[key] = float(diff.max())
                    rels[key] = float((diff / want[fin].abs().clamp(
                        min=1e-30)).max())
                    if combine != "max":
                        require(rels[key] <= GSPMM_ADD_RTOL,
                                f"gspmm {key}: max rel {rels[key]}")
        del feats, wide
    log({"phase": "kernels.gspmm.check", "max_abs_err": errs,
         "max_rel_err": rels})
    return errs


def _gspmm_timing(Kn, plan, gen, times):
    """gspmm with scalar weights and add at the widths in GSPMM_WIDTHS:
    kernel, plain and ``torch.sparse.mm`` device and eager times, the
    bound, and the largest hub run's own time: the kernel with only that
    run live less the kernel with no live slot (both still visit every
    target), measured HUB_REPEATS times interleaved, the median of the
    differences kept and the spread reported."""
    dev = plan.device
    a = _spmm_matrix(plan)
    hub, hub_only, empty = _hub_split(plan)
    out = {"largest_hub": hub}
    for f in GSPMM_WIDTHS:
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        dense = feats.view(plan.k * plan.v_max, f)
        lib = torch.sparse.mm(a, dense).view(plan.k, plan.v_max, f)
        got = Kn.gspmm(plan, feats, plan.edge_w, "add")
        lib_rel = float(((lib - got).abs()
                         / got.abs().clamp(min=1e-30)).max())
        iters = 20 if f <= 8 else 5
        t = times(iters=iters,
                  kernel=lambda: Kn.gspmm(plan, feats, plan.edge_w, "add"),
                  plain=lambda: Kn.gspmm_ref(plan, feats, plan.edge_w, "add"),
                  library=lambda: torch.sparse.mm(a, dense))
        pairs = [(device_ms(lambda: Kn.gspmm(hub_only, feats,
                                             hub_only.edge_w, "add")),
                  device_ms(lambda: Kn.gspmm(empty, feats, empty.edge_w,
                                             "add")))
                 for _ in range(HUB_REPEATS)]
        t["hub_only_ms"] = [h for h, _ in pairs]
        t["empty_ms"] = [e for _, e in pairs]
        t["hub_run_ms"] = float(np.median([h - e for h, e in pairs]))
        t["bound_ms"], t["bound_by"] = _gspmm_bound(plan, f)
        t["library_max_rel_vs_kernel"] = lib_rel
        out[f"f{f}"] = t
        del feats, dense, lib, got
    log({"phase": "kernels.gspmm.timing", **out})
    return out


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(plan, launches, gnn_launches):
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
    # ... and at the GNN programs' [K, Vmax, 8] loop state against a [V, 8]
    # global plane (every gcn_layer / kge_score exchange), F-strided
    state8 = torch.rand((plan.k, plan.v_max, 8), generator=gen, device=dev)
    state8 = torch.where(torch.rand(state8.shape, generator=gen, device=dev)
                         < 0.2, float("inf"), state8 * 30)
    glob8 = torch.rand((plan.n_vertices, 8), generator=gen, device=dev) * 30
    mu8_args = (state8, glob8, plan.local2global, plan.vmask,
                plan.replicated)
    for combine in ("min", "add"):
        got = Kn.masked_update(*mu8_args, combine)
        want = Kn.masked_update_ref(*mu8_args, combine)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"masked_update {combine} at F=8 not exact")
        fin = torch.isfinite(want)
        mu_err = max(mu_err, float((got[fin] - want[fin]).abs().max()))
    log({"phase": "kernels.masked_update.check", "exact": True,
         "shapes": [list(state.shape), list(state8.shape)],
         "max_abs_err": mu_err})

    # timing at the main path's shapes
    masked = {c: torch.where(plan.emask, m, Kn._IDENTITY[c]).reshape(-1)
              for c, m in (("min", dist), ("add", finite))}
    ident = {c: torch.full((plan.k * plan.v_max,), Kn._IDENTITY[c],
                           device=dev) for c in masked}
    def times(iters: int = 20, **fns):
        """Device ms (CUDA graph) and eager ms (with host launch cost)."""
        out = {f"{k}_ms": device_ms(f, iters=iters) for k, f in fns.items()}
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
    mu8_t = times(kernel=lambda: Kn.masked_update(*mu8_args, "add"),
                  plain=lambda: Kn.masked_update_ref(*mu8_args, "add"))
    mu8_t["bound_ms"], mu8_t["bound_by"] = _mu_bound(plan, 8)
    log({"phase": "kernels.timing", "segment_reduce": seg_t,
         "masked_update": mu_t, "masked_update_f8": mu8_t})
    gs_err = _gspmm_checks(Kn, plan, patched, gen)
    gs_t = _gspmm_timing(Kn, plan, gen, times)

    seg_bound, seg_by = _seg_bound(plan)
    mu_bound, mu_by = _mu_bound(plan)
    return {"kernels": [
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/engine/kernels.py:82",
         "launches": launches["segment_reduce"],
         "launches_gnn": gnn_launches["segment_reduce"],
         "max_abs_err": errs["plan.min"],
         "ms": seg_t["min"]["kernel_ms"],
         "plain_ms": seg_t["min"]["plain_ms"],
         "bound_ms": seg_bound, "bound_by": seg_by,
         "library_ms": seg_t["min"]["library_ms"],
         "combine": "min", "shape": [plan.k, plan.e_max]},
        {"name": "masked_update", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_update.cu",
         "replaces": "src/repro/engine/kernels.py:394",
         "launches": launches["masked_update"],
         "launches_gnn": gnn_launches["masked_update"], "max_abs_err": mu_err,
         "ms": mu_t["kernel_ms"], "plain_ms": mu_t["plain_ms"],
         "bound_ms": mu_bound, "bound_by": mu_by, "library_ms": None,
         "combine": "min", "shape": [plan.k, plan.v_max],
         "f8": {k: mu8_t[k] for k in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "gspmm", "route": "cuda",
         "source": "src/repro_torch/csrc/gspmm.cu",
         "replaces": "src/repro/engine/kernels.py:233",
         "launches": gnn_launches["gspmm"],
         "max_abs_err": gs_err["plan.f8.scalar.add"],
         "ms": gs_t["f8"]["kernel_ms"], "plain_ms": gs_t["f8"]["plain_ms"],
         "bound_ms": gs_t["f8"]["bound_ms"],
         "bound_by": gs_t["f8"]["bound_by"],
         "library_ms": gs_t["f8"]["library_ms"],
         "combine": "add", "shape": [plan.k, plan.e_max, 8],
         "f128": {k: gs_t["f128"][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "hub_run_ms")},
         "hub_run_ms_f8": gs_t["f8"]["hub_run_ms"]},
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
    g, plan, launches = phase_main()
    gnn_launches = phase_gnn(g, plan)
    kernel_line = phase_kernels(plan, launches, gnn_launches)
    phase_cpu_equal()
    print(card, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
