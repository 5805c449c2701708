"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

Phases, in the order they run (any failure raises, so the process exits
non-zero with no "ok" line):

1. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); build the eight CUDA kernels from
              ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, in
              parallel.
2. main     — the paper's pipeline at the EC2 scale, through the user entry
              points on the card: ``load_dataset("dblp", scale=1.0)``,
              ``dfep.partition(k=16, max_rounds=4000, stall_rounds=64)``
              with seeded starts, ``compile_plan``, ``Engine``, then SSSP
              from vertex 0, WCC and PageRank (30 supersteps). SSSP and WCC
              must equal a scipy.sparse.csgraph oracle exactly; PageRank
              must agree with the engine's plain path on the card and with a
              float64 numpy oracle to the relative tolerances below; SSSP,
              WCC and PageRank's counters, and SSSP's and WCC's states,
              must equal the engine's plain path's. The launch counters are
              zeroed before this phase; lane_cumsum (DFEP's rank cumsum)
              must have risen during ``dfep.partition``, and the engine's
              kernels (segment_reduce, exchange) by the phase's end, with
              one exchange launch a superstep and no masked_update.
3. gnn      — the second path on the main phase's plan, through the user
              entry points: ``engine_gcn_layer`` (x [V, 8], weight [8, 4]),
              ``engine_kge_score`` (entity [V, 8], relation [e_pad, 8]),
              ``engine_weighted_sssp(0)``, ``engine_bfs(0)``,
              ``engine_label_propagation`` and
              ``engine_personalized_pagerank`` (30 supersteps), inputs
              seeded from numpy. The counters are zeroed before it; gspmm
              must rise during gcn_layer and during kge_score, and every
              kernel of the path by its end (one exchange a superstep, no
              masked_update). wsssp, BFS and labelprop must
              equal host numpy/scipy oracles bit for bit; PPR must agree with
              the plain path on the card and with a float64 numpy oracle
              element by element, and gcn_layer and kge_score to a bound
              relative to their largest value (tolerances below).
4. serve    — the serving path on the main phase's graph and DFEP owner:
              ``compile_plan_cached`` (a miss, then a hit returning the
              same plan with its three kernel layouts built; the cache's
              counters 1 miss, 1 hit); ``multi_source_sssp`` from
              SERVE_LANES seeded sources against one ``engine_sssp`` per
              source (each lane bit for bit, equal supersteps, local
              iterations and convergence; the batch's exchange launches
              equal the longest lane's supersteps and its segment_reduce
              launches lie between the longest lane's sweeps and their
              sum; timed first and warm against the solo runs, warm);
              ``run_batched`` for bfs and wsssp at SERVE_SMALL lanes, cold
              and warm-started from a one-superstep batch with two rows
              +inf, each lane against its solo cold or warm run; then a
              ``GraphServer`` on the card answering SERVE_REQUESTS seeded
              requests of SERVE_TENANTS tenants (sssp, bfs, wsssp with
              repeated sources, wcc, pagerank 20 and 30, ppr, labelprop,
              one gcn_layer), every answer equal to a solo ``Engine`` run
              (min programs bit for bit, add within SERVE_ADD_ATOL), every
              micro-batch through the kernels; ``serve`` and ``drain`` (a
              second stream of SERVE_DRAIN) timed. The counters are zeroed
              just before ``serve`` and read just after.
5. etsch    — the paper's own dense ETSCH framework, metrics and baselines
              on the main phase's graph and DFEP owner, through the user
              entry points: ``etsch.compile_partitioning``, then
              ``etsch_sssp(0)`` (equal to scipy and to the main phase's
              engine SSSP), ``etsch_cc`` with seeded ids (each vertex the
              min id of its component), ``etsch_multi_sssp`` from 8 seeded
              sources (each row equal to scipy BFS), ``etsch_pagerank(30)``
              (PR_ORACLE_RTOL of the float64 oracle), ``etsch_mis`` with
              seeded priorities (a maximal independent set) and
              ``etsch_kcore`` (equal to a numpy peeling oracle), each timed
              first and warm; then ``metrics.evaluate`` (MESSAGES and the
              replication factor equal to the plan's, the gain equal to
              1 - supersteps / (eccentricity + 1)); the gain on the road
              network stand-in (usroads, full scale, DFEP K=16: > 0 and
              equal to the same formula); and the paper's Fig. 7
              comparison: hash, random, greedy and JaBeJa partitions
              through ``metrics.evaluate``. The counters are zeroed before
              it; minplus_sweep and frontier_min must rise in
              ``etsch_sssp`` and minplus_sweep in ``evaluate``; each
              problem's line logs its minplus_sweep launches by state
              rows ([K·V], [K·8·V], [V]).
6. lm       — Mamba serving at falcon-mamba-7b's full width and depth
              (64 layers, d_model 4096, d_inner 8192, d_state 16, vocab
              65,024): ``lm.init_params`` on the card from a seeded
              generator (float32, 27.1 GiB), then B = LM_BATCH seeded
              prompts of LM_PROMPT tokens through ``serve_step.prefill``
              (first and warm), ``decode`` steps (ms per step) and
              ``Engine.generate`` of LM_NEW tokens. The counters are zeroed
              just before ``generate``; selective_scan must have run once
              per layer and forward, n_layers · LM_NEW times. Checks: every
              logit finite; the decode logits for token s equal the last
              logits of a prefill of s + 1 tokens within a bound of the
              largest (bf16_rel), while decode from a wrong cache (the conv
              window padded as the reference pads it, or a zeroed state)
              must fall outside it. The scan's inputs at the first and the
              last layer of the prompt's prefill are kept for the kernels
              phase, and the model is freed before it.
7. kernels  — each kernel against its plain version on the main path's plan
              tensors and on a seeded plan-shaped input with deleted prefix
              slots, arrived vertices and a live append region
              (segment_reduce's add also against a second call, bit for
              bit, and its per-plan layout's build time and counts logged;
              gspmm at F = 1, 8 and 128, add/max/mean, scalar and per-feature
              weights, add also against a second call, bit for bit;
              masked_update, the glob-form update no single-device path
              launches now, scalar and at the GNN state's F=8; exchange,
              the whole replica exchange, at F = 1 and 8, min/add/max, on
              the main path's plan, the patched one, a hub in all K
              partitions and the main graph compiled for K + 1 partitions
              (the last empty): bit for bit against its layout's plain
              walk, min and max exact and add within EXCHANGE_ADD_ATOL of
              the reference chain, two add calls the same bits, and each
              plan's layout build time and counts logged);
              lane_cumsum on DFEP's [2·e_pad, 16] and [V, 16] 0/1 arrays
              (int32, exact) and a float32 case, frontier_min on [16, V]
              with the real member mask and at multi-source SSSP's
              [16, N_SOURCES·V] (both timed; each of the two kernels'
              timing graphs is replayed once more on a changed input and
              held exact against the plain version, which catches look-back
              flags that were not reset), minplus_sweep on ETSCH's flat
              [K·V] state, the whole graph, multi-source SSSP's [K·8·V]
              state and usroads' flat state at costs 1 and 0, with and
              without a prebuilt layout (all exact; each timed, its timing
              graph replayed once more and held exact; the layouts' build
              time logged); then timed: device time from CUDA-graph replays
              (``ms``, ``plain_ms``, ``library_ms``) and eager back-to-back
              calls with their host launch cost (``*_eager_ms``), exchange
              at EXCHANGE_CASES against the parent's chain (its
              ``library_ms``: where, full, scatter_reduce_ and the
              masked_update kernel), also in turns (chain, kernel, kernel,
              chain), segment_reduce and exchange (min) at the serve
              path's lane widths SERVE_WIDTHS (exact against their plain
              versions; the rows gain ``lanes`` and ``serve_launches``),
              gspmm
              at F = 8 and 128 with scalar weights and at kge_score's F = 8
              with per-feature weights, also with only its largest hub run
              live and with no live slot (the difference is the hub run's
              time); prints one
              ``{"kernels": [...]}`` line. selective_scan is held against
              its plain loop (y and h_last within SCAN_REL) on seeded
              inputs at the prefill shape with a zero and a random h0, at
              S = 1, and on the lm phase's captured layer inputs, and timed
              at the prefill shape and at S = 1, each beside its bound
              (bytes, float32 operations, and exps at the SFUs' rate).
8. cpu      — dblp at scale 0.03, K=16, the same starts: the port on the card
              and the port on the CPU give the same DFEP owner array and
              rounds, the same engine SSSP result, the same ETSCH SSSP and CC
              (same ids) states and counters, and the same partition
              metrics; and the falcon-mamba SMOKE model with the same
              parameters on both: logits within bf16_rel(4), and
              the card's greedy tokens the CPU's (up to bfloat16 ties).

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
#  * segment_reduce add: the kernel sums a run in slot order, or in a
#    warp's or a block's shuffle tree, then the target's append
#    slots in slot order; the plain version scatters with atomics in another
#    order. Hub runs hold thousands of float32 terms.
SEG_ADD_RTOL = 1e-4
#  * PageRank kernel path vs plain path on the card: the same sums in other
#    orders, 30 supersteps; ranks are ~3e-6, so the bound is relative.
PR_PLAIN_RTOL = 1e-4
#  * PageRank vs a float64 numpy oracle: float32 accumulation over 30 steps.
PR_ORACLE_RTOL = 1e-3
#  * gspmm add/mean vs plain, on non-negative features and weights: the
#    kernel sums a run in slot order over a tile's lane groups, or a hub's
#    chunks in a fixed tree and then in chunk order; the plain version
#    scatters with atomics in another order. Hub runs hold ~10^4 float32
#    terms.
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
#  * lane_cumsum on float32 values in [0, 1) against a float64 cumsum,
#    relative to the running sum: float32 rounding over 1.9 M terms, summed
#    per tile and per row group rather than in order. int32 is exact.
FLOAT_CUMSUM_RTOL = 1e-4
#  * exchange add vs the reference chain, on values in [0, 1): the same
#    sums of at most K = 16 terms in another order (the chain's atomics),
#    a few float32 roundings of sums below 16 (an ulp there is 1.9e-6).
#    Against the layout's plain walk every combine is bit for bit.
EXCHANGE_ADD_ATOL = 1e-5
#  * selective_scan kernel vs its plain loop, relative to the largest
#    |y| and |h_last|: both float32 and the same recurrence; the kernel
#    contracts multiply-adds and sums the 16-term dot in shuffle order
#    (~2e-7 measured on seeded inputs), and 512 steps compound that.
SCAN_REL = 1e-5
#  * two bfloat16 runs of the same n-layer model that round differently,
#    relative to the largest logit: bf16_rel(n) (below). Used for decode
#    logits vs the last logits of a prefill of one more token (cuBLAS sums
#    at M = 4 and at M = 2,052 in other orders; on the CPU the port gives
#    exactly 0.0 there), and for the SMOKE model on the card vs on the CPU
#    (cuBLAS vs the CPU's GEMMs), where greedy tokens must be the CPU's
#    wherever the CPU's top two logits are further apart than the bound
#    (bf16 logits tie, and a flip decides a tie).
DBLP_SCALE, K, SEED = 1.0, 16, 0
#: The lm phase: falcon-mamba-7b at full width and depth, B prompts of S
#: tokens, LM_NEW new tokens each.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "falcon-mamba-7b", 4, 512, 16
CPU_CHECK_SCALE = 0.03
#: The kernels each path must launch.
MAIN_KERNELS = ("segment_reduce", "exchange")
GNN_KERNELS = ("gspmm", "segment_reduce", "exchange")
ETSCH_KERNELS = ("minplus_sweep", "frontier_min")
#: etsch_multi_sssp's seeded sources.
N_SOURCES = 8
#: etsch_kcore's k. The dblp stand-in (Barabási–Albert, m = 3) is
#: 3-degenerate: its 3-core is the whole graph and its 4-core is empty, so
#: no k has a core strictly between; k = 4 peels the whole graph away, the
#: longest run.
K_CORE = 4
#: exchange cases timed: (label, F, combine) — the main path's scalar min
#: (SSSP, WCC) and add (PageRank), the gnn path's [K, Vmax, 8] add and max.
EXCHANGE_CASES = (("f1_min", 1, "min"), ("f1_add", 1, "add"),
                  ("f8_add", 8, "add"), ("f8_max", 8, "max"))
#: The hub plan of the exchange check: a star of this many leaves.
EXCHANGE_HUB_LEAVES = 100_000
#: gspmm widths timed: the GNN programs' (8) and fig_gnn.py's widest (128).
GSPMM_WIDTHS = (8, 128)
#: Interleaved repeats of the largest hub run's timing (its spread is the
#: run-to-run noise of a difference of two device times).
HUB_REPEATS = 3
#: The serve phase: multi_source_sssp's lanes, run_batched's lanes for
#: bfs and wsssp and the rows of their warm block set to +inf (cold), the
#: GraphServer's tenants and its seeded request stream, and a second
#: stream for ``drain``. Add programs (pagerank, ppr, gcn_layer) are held
#: to their solo runs within SERVE_ADD_ATOL (the reference's oracle
#: bound); min programs bit for bit.
SERVE_LANES, SERVE_SMALL, SERVE_COLD_ROWS = 32, 8, (2, 5)
SERVE_TENANTS, SERVE_REQUESTS, SERVE_DRAIN = 4, 256, 64
SERVE_ADD_ATOL = 1e-5
SERVE_KERNELS = ("segment_reduce", "exchange", "gspmm")
#: Lane widths at which segment_reduce and exchange are timed: a full
#: micro-batch of the default buckets (32) and a middle one (8).
SERVE_WIDTHS = (8, 32)


def bf16_rel(n_layers: int) -> float:
    """Bound between two bf16 runs of one n-layer model that round
    differently: each layer's residual output may round one bf16 ulp
    (2^-8 relative) the other way, and such flips add like a random walk,
    √n · 2^-8; the bound is twice that (6.25% at 64 layers, 1.6% at 4)."""
    return 2 * n_layers ** 0.5 * 2.0 ** -8


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


def device_ms(fn, iters: int = 20, replays: int = 5, check=None) -> float:
    """Mean device time of one ``fn`` call in ms: ``iters`` calls captured
    in a CUDA graph, replayed ``replays`` times between CUDA events, so no
    host launch cost is in the number. ``fn`` is warmed first (lazy
    library loads, memoised plan indices) on a side stream. With ``check``,
    after the timing replays ``check(replay, out)`` is called with the
    graph's replay and the output of its last ``fn`` call, to hold one more
    replay against the plain version."""
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
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    if check is not None:
        check(graph.replay, out)
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


def kcore_oracle(g, k_core: int) -> np.ndarray:
    """The k-core by peeling on the host: drop vertices of live degree
    below k until none is left to drop."""
    u, v = g.as_numpy()
    n = g.n_vertices
    active = np.bincount(np.concatenate([u, v]), minlength=n) > 0
    while True:
        live = active[u] & active[v]
        deg = (np.bincount(u[live], minlength=n)
               + np.bincount(v[live], minlength=n))
        new = active & (deg >= k_core)
        if np.array_equal(new, active):
            return active
        active = new


def is_mis_oracle(csr, in_set: np.ndarray) -> bool:
    """``in_set`` is a maximal independent set of the graph ``csr``: no
    edge inside it, and every vertex with an edge is in it or next to it."""
    coo = csr.tocoo()
    independent = not (in_set[coo.row] & in_set[coo.col]).any()
    nbr_in = np.zeros(len(in_set), bool)
    nbr_in[coo.row[in_set[coo.col]]] = True
    has_edge = np.diff(csr.indptr) > 0
    return independent and bool((in_set | nbr_in | ~has_edge).all())


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


def _one_exchange_a_superstep(launches: dict, results, path: str) -> None:
    """The engine's exchange is one ``exchange`` launch a superstep and
    never the glob-form ``masked_update``."""
    steps = sum(r.supersteps for r in results)
    require(launches["exchange"] == steps and launches["masked_update"] == 0,
            f"{path}: {launches['exchange']} exchange and "
            f"{launches['masked_update']} masked_update launches for "
            f"{steps} supersteps")


def phase_main():
    from repro_torch.core import dfep, graph
    from repro_torch import engine as E
    from repro_torch.engine import kernels
    from repro_torch.kernels import ops

    kernels.reset_launches()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    g, t = wall(lambda: graph.load_dataset("dblp", scale=DBLP_SCALE,
                                           seed=SEED))
    log({"phase": "main.load_dataset", "wall_s": t, "n_vertices": g.n_vertices,
         "n_edges": g.n_edges, "e_pad": g.e_pad,
         "max_degree": int(g.degrees().max()), "peak_mib": peak_mib()})

    torch.cuda.reset_peak_memory_stats()
    (owner, info), t = wall(lambda: dfep.partition(
        g, k=K, seed=SEED, max_rounds=4000, stall_rounds=64))
    dfep_launches = dict(ops.LAUNCHES)
    log({"phase": "main.dfep", "wall_s": t, "rounds": info["rounds"],
         "unsold_at_stop": info["unsold_at_stop"],
         "finalized": info["finalized"], "starts": info["starts"],
         "ms_per_round": 1e3 * t / max(info["rounds"], 1),
         "launches": dfep_launches, "peak_mib": peak_mib()})
    require(dfep_launches["lane_cumsum"] > 0,
            "kernel lane_cumsum was not launched by DFEP")
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
    _one_exchange_a_superstep(launches, results.values(), "main")

    csr = csr_of(g)
    sssp = results["sssp"].state.cpu().numpy()
    require(np.array_equal(sssp, sssp_oracle(csr, 0)),
            "SSSP differs from the scipy oracle")
    wcc = results["wcc"].state.cpu().numpy()
    require(np.array_equal(wcc, wcc_oracle(csr)),
            "WCC differs from the scipy oracle")
    require(all(results[n].converged for n in ("sssp", "wcc")),
            "SSSP/WCC did not converge")
    plain_eng = E.Engine(plan, use_kernels=False)
    for name, run in (("sssp", E.engine_sssp), ("wcc", E.engine_wcc)):
        ref = run(plain_eng, *((0,) if name == "sssp" else ()))
        require(torch.equal(results[name].state, ref.state)
                and results[name].row() == ref.row(),
                f"{name}: kernel path differs from the plain path")
    pr = results["pagerank"].state
    pr_plain, t = wall(lambda: E.engine_pagerank(plain_eng, g.degrees(),
                                                 iters=30))
    rel_plain = max_rel(pr, pr_plain.state)
    rel_oracle = max_rel(pr, pagerank_oracle(g))
    require(results["pagerank"].row() == pr_plain.row(),
            "PageRank counters differ from the plain path")
    log({"phase": "main.check", "sssp_equal_oracle": True,
         "wcc_equal_oracle": True, "sssp_wcc_equal_plain": True,
         "pagerank_max_rel_vs_plain": rel_plain,
         "pagerank_plain_wall_s": t, "pagerank_max_rel_vs_f64_oracle":
             rel_oracle, "launches": launches})
    require(rel_plain <= PR_PLAIN_RTOL, f"PageRank kernel vs plain path: "
            f"max rel {rel_plain} > {PR_PLAIN_RTOL}")
    require(rel_oracle <= PR_ORACLE_RTOL, f"PageRank vs float64 oracle: "
            f"max rel {rel_oracle} > {PR_ORACLE_RTOL}")
    launches.update(dfep_launches)
    return g, owner, plan, launches, results["sssp"].state


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
    _one_exchange_a_superstep(launches, results.values(), "gnn")
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


# ---------------------------------------------------------------------------
# The serve phase
# ---------------------------------------------------------------------------

def _lane_counts(r, i: int) -> tuple:
    return (int(r.supersteps[i]), int(r.local_iters[i]),
            bool(r.converged[i]))


def _solo_equal(r, i: int, solo, what: str) -> None:
    """Lane ``i`` of the batched result ``r`` is the solo run ``solo``:
    the same state bit for bit and the same counters."""
    require(torch.equal(r.state[i], solo.state),
            f"{what}: lane {i} differs from its solo run")
    require(_lane_counts(r, i) == (solo.supersteps, solo.local_iters,
                                   solo.converged),
            f"{what}: lane {i} counters {_lane_counts(r, i)} vs solo "
            f"{(solo.supersteps, solo.local_iters, solo.converged)}")


def _serve_plan_cache(g, owner):
    """compile_plan_cached: a miss, then a hit that returns the same plan
    with its three kernel layouts built."""
    from repro_torch import engine as E
    E.plan_cache_clear(reset_counters=True)
    plan, t_miss = wall(lambda: E.compile_plan_cached(g, owner, K))
    hit, t_hit = wall(lambda: E.compile_plan_cached(g, owner, K))
    stats = E.plan_cache_stats()
    built = [key for key in ("_segment_layout", "_gspmm_layout",
                             "_exchange_layout") if key in hit.__dict__]
    log({"phase": "serve.plan_cache", "miss_s": t_miss, "hit_s": t_hit,
         "stats": stats, "layouts_built": built})
    require(hit is plan, "compile_plan_cached: the hit is another object")
    require(len(built) == 3, f"compile_plan_cached: layouts built {built}")
    require((stats["misses"], stats["hits"]) == (1, 1),
            f"plan cache counters {stats}")
    return plan, {"miss_s": t_miss, "hit_s": t_hit}


def _serve_multi_source(eng, sources) -> dict:
    """multi_source_sssp over SERVE_LANES sources against one solo
    engine_sssp per source: each lane bit-identical with equal counters;
    one segment_reduce launch a sweep and one exchange a superstep of the
    batch, so the launches follow the longest lane, not the sum."""
    from repro_torch import engine as E
    from repro_torch.engine import kernels
    kernels.reset_launches()
    r, t_first = wall(lambda: E.multi_source_sssp(eng, sources))
    batched = dict(kernels.LAUNCHES)
    _, t_warm = wall(lambda: E.multi_source_sssp(eng, sources))
    for s in sources[:2]:                 # warm the solo path
        E.engine_sssp(eng, int(s))
    kernels.reset_launches()
    solo, t_solo = wall(lambda: [E.engine_sssp(eng, int(s))
                                 for s in sources])
    solo_launches = dict(kernels.LAUNCHES)
    for i, one in enumerate(solo):
        _solo_equal(r, i, one, "multi_source_sssp")
    steps = [one.supersteps for one in solo]
    sweeps = [one.local_iters for one in solo]
    out = {"lanes": len(sources), "batched_first_s": t_first,
           "batched_warm_s": t_warm, "solo_warm_s": t_solo,
           "solo_over_batched": t_solo / t_warm,
           "supersteps": {"max": max(steps), "sum": sum(steps)},
           "local_iters": {"max": max(sweeps), "sum": sum(sweeps)},
           "launches_batched": batched, "launches_solo": solo_launches}
    log({"phase": "serve.multi_source_sssp", **out})
    require(batched["exchange"] == max(steps),
            f"batched exchange launches {batched['exchange']} != the "
            f"longest lane's {max(steps)} supersteps")
    require(max(sweeps) <= batched["segment_reduce"] < sum(sweeps),
            f"batched segment_reduce launches {batched['segment_reduce']}"
            f" not in [{max(sweeps)}, {sum(sweeps)})")
    require(solo_launches["exchange"] == sum(steps)
            and solo_launches["segment_reduce"] == sum(sweeps),
            f"solo launches {solo_launches}")
    return out


def _serve_run_batched(eng, rng, n) -> dict:
    """run_batched for bfs and wsssp at SERVE_SMALL lanes, cold and warm
    (the block of a one-superstep batched run, two rows +inf), each lane
    against its solo run."""
    from repro_torch import engine as E
    out = {}
    for prog in (E.BFS, E.WEIGHTED_SSSP):
        src = rng.choice(n, SERVE_SMALL, replace=False)
        bkw = {"source": src}
        r, t = wall(lambda: eng.run_batched(prog, bkw))
        for i, s in enumerate(src):
            _solo_equal(r, i, eng.run(prog, source=int(s)), prog.name)
        block = eng.run_batched(prog, bkw, max_supersteps=1).state.clone()
        block[list(SERVE_COLD_ROWS)] = float("inf")
        w, t_warm = wall(lambda: eng.run_batched(prog, bkw,
                                                 warm_state=block))
        for i, s in enumerate(src):
            solo = eng.run(prog, source=int(s)) if i in SERVE_COLD_ROWS \
                else eng.run(prog, source=int(s), warm_state=block[i])
            _solo_equal(w, i, solo, f"{prog.name} warm")
        out[prog.name] = {"cold_s": t, "warm_s": t_warm,
                          "supersteps_cold": r.supersteps.tolist(),
                          "supersteps_warm": w.supersteps.tolist()}
    log({"phase": "serve.run_batched", "lanes": SERVE_SMALL,
         "cold_rows": list(SERVE_COLD_ROWS), **out})
    return out


def _serve_requests(G, rng, n, planes, count: int) -> list:
    """A seeded stream of ``count`` requests from SERVE_TENANTS tenants,
    in a seeded order: 27/32 of them sssp, bfs and wsssp, a quarter of
    whose sources repeat an earlier request of the same program (cache
    hits, or lanes shared in one micro-batch); the rest wcc, pagerank
    (iters 20 and 30), ppr and labelprop on seeded planes, and one
    gcn_layer."""
    kinds, seen = [], {"sssp": [], "bfs": [], "wsssp": []}
    for i in range(count * 27 // 32):
        kind = ("sssp", "bfs", "wsssp")[i % 3]
        if seen[kind] and rng.random() < 0.25:
            s = seen[kind][int(rng.integers(len(seen[kind])))]
        else:
            s = int(rng.integers(n))
            seen[kind].append(s)
        kinds.append((kind, {"source": s}))
    kinds.append(("gcn_layer", {"x": planes["x"], "weight": planes["w"]}))
    others = [("wcc", {}), ("pagerank", {"iters": 20}),
              ("pagerank", {"iters": 30}),
              ("ppr", {"personalization": planes["p"]}),
              ("labelprop", {"labels": planes["labels"]})]
    while len(kinds) < count:
        kinds.append(others[len(kinds) % len(others)])
    return [G.QueryRequest(kinds[j][0], tenant=f"t{i % SERVE_TENANTS}",
                           params=kinds[j][1])
            for i, j in enumerate(rng.permutation(count))]


def _solo_value(E, eng, g, req):
    """The solo Engine run of one served query, as a host array."""
    prm = req.params
    deg = g.degrees()
    run = {"sssp": lambda: eng.run(E.SSSP, source=prm.get("source")),
           "bfs": lambda: eng.run(E.BFS, source=prm.get("source")),
           "wsssp": lambda: eng.run(E.WEIGHTED_SSSP,
                                    source=prm.get("source")),
           "wcc": lambda: E.engine_wcc(eng),
           "pagerank": lambda: E.engine_pagerank(eng, deg,
                                                 prm.get("iters")),
           "ppr": lambda: E.engine_personalized_pagerank(
               eng, deg, np.array(prm.get("personalization")),
               prm.get("iters")),
           "labelprop": lambda: E.engine_label_propagation(
               eng, np.array(prm.get("labels"))),
           "gcn_layer": lambda: E.engine_gcn_layer(
               eng, deg, np.array(prm.get("x")),
               np.array(prm.get("weight")))}[req.kind]
    return run().state.cpu().numpy()


def phase_serve(g, owner):
    """The serving path on the main phase's graph and DFEP owner: the plan
    cache, batched multi-source SSSP against solo runs, warm-started
    batches, then a GraphServer on the card answering a seeded request
    stream from several tenants, every answer against a solo run."""
    from repro_torch import engine as E
    from repro_torch import gserve as G
    from repro_torch.engine import kernels

    plan, cache_t = _serve_plan_cache(g, owner)
    n = g.n_vertices
    rng = np.random.default_rng(SEED)
    ms = _serve_multi_source(E.Engine(plan),
                             rng.choice(n, SERVE_LANES, replace=False))
    rb = _serve_run_batched(E.Engine(plan), rng, n)

    dispatches = []

    def counted(prog, lanes: int, fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        dispatches.append({"program": prog.name, "bucket": lanes,
                           "launches": _delta(before, kernels.LAUNCHES)})
        return out

    class Counted(E.Engine):
        """The engine, with the kernel launches of each dispatch logged."""
        def dispatch(self, prog, *args, **kw):
            return counted(prog, 1, lambda: E.Engine.dispatch(
                self, prog, *args, **kw))

        def dispatch_batched(self, prog, batched_kw, *args, **kw):
            lanes = len(next(iter(batched_kw.values())))
            return counted(prog, lanes, lambda: E.Engine.dispatch_batched(
                self, prog, batched_kw, *args, **kw))

    p = rng.random(n)
    planes = {"x": E.ChannelValue(rng.normal(size=(n, E.GCN_F_IN))),
              "w": E.ChannelValue(rng.normal(size=(E.GCN_F_IN,
                                                   E.GCN_F_OUT))),
              "p": E.ChannelValue(p / p.sum()),
              "labels": E.ChannelValue(rng.permutation(n))}
    reqs = _serve_requests(G, rng, n, planes, SERVE_REQUESTS)
    srv = G.GraphServer(Counted(plan), g)
    kernels.reset_launches()
    out, t_serve = wall(lambda: srv.serve(reqs))
    serve_launches = dict(kernels.LAUNCHES)
    stats = srv.stats()
    served = list(dispatches)
    for name in SERVE_KERNELS:
        require(serve_launches[name] > 0,
                f"kernel {name} was not launched on the serve path")
    for d in served:
        ls = d["launches"]
        require(ls["exchange"] > 0 and ls["segment_reduce"] + ls["gspmm"]
                > 0 and ls["masked_update"] == 0,
                f"a {d['program']} micro-batch of {d['bucket']} lanes ran "
                f"no kernel: {ls}")
    require([r.request.id for r in out] == [r.id for r in reqs]
            and all(r.error is None for r in out), "serve: results")

    t0 = time.perf_counter()
    eng = E.Engine(plan)
    solo, worst = {}, 0.0
    for r in out:
        key = r.request.cache_key()
        if key not in solo:
            solo[key] = _solo_value(E, eng, g, r.request)
        want = solo[key]
        require(r.value.shape == want.shape and r.value.dtype == want.dtype,
                f"serve {r.request.kind}: {r.value.shape} vs {want.shape}")
        if r.request.entry.oracle_atol:         # add programs
            err = float(np.abs(r.value - want).max())
            worst = max(worst, err)
            require(err <= SERVE_ADD_ATOL, f"serve {r.request.kind}: max "
                    f"abs {err} vs its solo run > {SERVE_ADD_ATOL}")
        else:
            require(np.array_equal(r.value, want),
                    f"serve {r.request.kind} {r.request.params}: differs "
                    "from its solo run")
    solo_s = time.perf_counter() - t0

    by_bucket, per = {}, {}
    for d in served:
        b = str(d["bucket"])
        by_bucket[b] = by_bucket.get(b, 0) + 1
        for k in ("segment_reduce", "exchange", "gspmm"):
            per.setdefault(k, []).append(d["launches"][k])
    drain_reqs = _serve_requests(G, np.random.default_rng(SEED + 1), n,
                                 planes, SERVE_DRAIN)
    for r in drain_reqs:
        srv.submit(r)
    drained, t_drain = wall(srv.drain)
    require(len(drained) == SERVE_DRAIN
            and all(r.error is None for r in drained), "drain: results")
    srv.close()
    result = {
        "requests": SERVE_REQUESTS, "tenants": SERVE_TENANTS,
        "serve_s": t_serve, "qps": SERVE_REQUESTS / t_serve,
        "latency_p50_s": stats["latency_p50_s"],
        "latency_p99_s": stats["latency_p99_s"],
        "micro_batches": len(served), "micro_batches_by_bucket":
            dict(sorted(by_bucket.items(), key=lambda kv: int(kv[0]))),
        "cache_hits": stats["result_cache_hits"],
        "launches_per_micro_batch": {k: {"mean": float(np.mean(v)),
                                         "max": int(max(v))}
                                     for k, v in per.items()},
        "launches": serve_launches,
        "add_max_abs_vs_solo": worst, "solo_checks": len(solo),
        "solo_check_s": solo_s, "drain_requests": SERVE_DRAIN,
        "drain_s": t_drain, "drain_qps": SERVE_DRAIN / t_drain}
    log({"phase": "serve.server", **result})
    return {"plan_cache": cache_t, "multi_source": ms, "run_batched": rb,
            "server": result, "launches": serve_launches}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _minplus_rows_since(before: dict) -> dict:
    """minplus_sweep launches by state rows since ``before`` (a copy of
    ``ops.MINPLUS_LAUNCHES_BY_ROWS``), as a loggable dict."""
    from repro_torch.kernels import ops
    got = _delta(before, ops.MINPLUS_LAUNCHES_BY_ROWS)
    return {str(rows): n for rows, n in sorted(got.items()) if n}


def _road_gain():
    """The paper's gain where it shows: on a large-diameter graph. The
    small-world dblp stand-in is a few hops across, so an ETSCH superstep
    there moves about one hop, as a vertex-centric round does, and the gain
    is 0. The road-network stand-in (USROADS, full scale) is partitioned
    by DFEP as the main phase partitions dblp; ETSCH SSSP from vertex 0 must
    equal scipy, and its gain must be > 0 and equal to 1 - supersteps /
    (eccentricity + 1)."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import dfep, etsch, graph, metrics

    road, t_load = wall(lambda: graph.load_dataset("usroads", scale=1.0,
                                                   seed=SEED))
    (owner, info), t_dfep = wall(lambda: dfep.partition(
        road, k=K, seed=SEED, max_rounds=4000, stall_rounds=64))
    part = etsch.compile_partitioning(road, owner, K)
    m, t = wall(lambda: metrics.evaluate(road, owner, K, part=part))
    res = A.etsch_sssp(part, 0)
    dist = sssp_oracle(csr_of(road), 0)
    ecc = int(dist[np.isfinite(dist)].max())
    log({"phase": "etsch.road_gain", "dataset": "usroads",
         "n_vertices": road.n_vertices, "n_edges": road.n_edges,
         "load_wall_s": t_load, "dfep_wall_s": t_dfep,
         "dfep_rounds": info["rounds"], "evaluate_wall_s": t, **m.row(),
         "etsch_supersteps": res.supersteps,
         "etsch_local_sweeps": res.local_iters, "eccentricity_of_0": ecc})
    require(np.array_equal(res.state.cpu().numpy(), dist),
            "etsch_sssp on usroads differs from the scipy oracle")
    require(m.gain == 1.0 - res.supersteps / (ecc + 1),
            f"usroads gain {m.gain} != 1 - {res.supersteps} / ({ecc} + 1)")
    require(m.gain > 0, f"usroads gain {m.gain} is not > 0")
    return part


def phase_etsch(g, owner, plan, engine_sssp_state):
    """The paper's dense ETSCH framework, its metrics and the baseline
    partitioners on the main phase's graph and DFEP owner."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import baselines as B
    from repro_torch.core import etsch, metrics
    from repro_torch.kernels import ops

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    part, t = wall(lambda: etsch.compile_partitioning(g, owner, K))
    log({"phase": "etsch.compile_partitioning", "wall_s": t,
         "e_max": part.e_max, "state_slots": part.k * part.n_vertices,
         "peak_mib": peak_mib()})

    rng = np.random.default_rng(SEED)
    n = g.n_vertices
    ids = rng.permutation(n)
    sources = rng.choice(n, N_SOURCES, replace=False)
    prio = rng.uniform(1e-6, 1.0, n).astype(np.float32)
    problems = {
        "sssp": lambda: A.etsch_sssp(part, 0),
        "cc": lambda: A.etsch_cc(part, ids=ids),
        "multi_sssp": lambda: A.etsch_multi_sssp(part, sources),
        "pagerank": lambda: A.etsch_pagerank(part, g.degrees(), iters=30),
        "mis": lambda: A.etsch_mis(part, prio=prio),
        "kcore": lambda: A.etsch_kcore(part, K_CORE),
    }
    results = {}
    for name, run in problems.items():
        torch.cuda.reset_peak_memory_stats()
        before = dict(ops.LAUNCHES)
        before_rows = dict(ops.MINPLUS_LAUNCHES_BY_ROWS)
        r, t = wall(run)
        got = _delta(before, ops.LAUNCHES)
        by_rows = _minplus_rows_since(before_rows)
        results[name] = r
        _, t_warm = wall(run)
        # sweeps of the local phase: counted by run_etsch for SSSP/CC, one
        # minplus_sweep each for multi-SSSP, one pass per superstep for the
        # plain-torch problems (PageRank, MIS, k-core)
        sweeps = (r.local_iters if hasattr(r, "local_iters")
                  else got["minplus_sweep"] if name == "multi_sssp"
                  else r.supersteps)
        log({"phase": f"etsch.{name}", "wall_s": t, "warm_wall_s": t_warm,
             "supersteps": r.supersteps, "local_sweeps": sweeps,
             "launches": got, "minplus_by_rows": by_rows,
             "peak_mib": peak_mib()})
        if name == "sssp":
            for k in ETSCH_KERNELS:
                require(got[k] > 0, f"etsch_sssp did not launch {k}")

    t0 = time.perf_counter()
    csr = csr_of(g)
    sssp = results["sssp"].state.cpu().numpy()
    dist0 = sssp_oracle(csr, 0)
    require(np.array_equal(sssp, dist0),
            "etsch_sssp differs from the scipy oracle")
    require(torch.equal(results["sssp"].state, engine_sssp_state),
            "etsch_sssp differs from the engine's SSSP")
    cc = results["cc"].state.cpu().numpy()
    require(np.array_equal(cc, labelprop_oracle(csr, ids.astype(np.float32))),
            "etsch_cc is not the min id of each component")
    multi = results["multi_sssp"].dist
    require(tuple(multi.shape) == (N_SOURCES, n), f"etsch_multi_sssp: "
            f"shape {tuple(multi.shape)}")
    require(np.array_equal(multi.cpu().numpy(),
                           sssp_oracle(csr, sources)),
            "etsch_multi_sssp differs from scipy BFS")
    rank = results["pagerank"].rank
    pr_rel = max_rel(rank, pagerank_oracle(g))
    require(pr_rel <= PR_ORACLE_RTOL, f"etsch_pagerank vs float64 oracle: "
            f"max rel {pr_rel} > {PR_ORACLE_RTOL}")
    in_set = results["mis"].in_set.cpu().numpy()
    require(is_mis_oracle(csr, in_set) and A.is_maximal_independent_set(
        g, results["mis"].in_set), "etsch_mis is not a maximal independent "
        "set")
    core = results["kcore"].in_core.cpu().numpy()
    require(np.array_equal(core, kcore_oracle(g, K_CORE)),
            "etsch_kcore differs from the peeling oracle")
    log({"phase": "etsch.check", "oracle_s": time.perf_counter() - t0,
         "equal_oracle": ["sssp", "cc", "multi_sssp", "kcore"],
         "sssp_equal_engine": True, "pagerank_max_rel_vs_f64_oracle": pr_rel,
         "mis_size": int(in_set.sum()), "kcore_size": int(core.sum()),
         "multi_sssp_state_mib": 4 * K * N_SOURCES * n / 2**20})

    # The gain compares ETSCH supersteps with vertex-centric rounds, which
    # are the source's eccentricity + 1 (the last round changes nothing);
    # it is held to that formula with scipy's eccentricity.
    before = dict(ops.LAUNCHES)
    before_rows = dict(ops.MINPLUS_LAUNCHES_BY_ROWS)
    m, t = wall(lambda: metrics.evaluate(g, owner, K, part=part))
    got = _delta(before, ops.LAUNCHES)
    by_rows = _minplus_rows_since(before_rows)
    ecc = int(dist0.max())
    steps = results["sssp"].supersteps
    log({"phase": "etsch.evaluate", "partitioner": "dfep", "wall_s": t,
         **m.row(), "eccentricity_of_0": ecc, "launches": got,
         "minplus_by_rows": by_rows})
    require(got["minplus_sweep"] > 0, "evaluate did not launch minplus_sweep")
    require(m.messages == plan.exchange_volume, f"MESSAGES {m.messages} != "
            f"the plan's exchange volume {plan.exchange_volume}")
    require(m.replication_factor == plan.replication_factor(),
            "replication factor differs from the plan's")
    require(m.gain == 1.0 - steps / (ecc + 1), f"gain {m.gain} != 1 - "
            f"{steps} / ({ecc} + 1)")
    road_part = _road_gain()

    baselines = {
        "hash": lambda: B.hash_partition(g, K),
        "random": lambda: B.random_partition(g, K, seed=SEED),
        "greedy": lambda: B.greedy_partition(g, K, seed=SEED),
        "jabeja": lambda: B.jabeja_partition(g, K, seed=SEED)[0],
    }
    fig7 = {"dfep": m.row()}
    for name, make in baselines.items():
        own, t_part = wall(make)
        mb, t_eval = wall(lambda: metrics.evaluate(g, own, K))
        fig7[name] = mb.row()
        log({"phase": "etsch.fig7", "partitioner": name,
             "partition_wall_s": t_part, "evaluate_wall_s": t_eval,
             **mb.row()})
    launches = dict(ops.LAUNCHES)
    for name in ETSCH_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the etsch path")
    launches["minplus_by_rows"] = _minplus_rows_since({})
    log({"phase": "etsch.summary", "launches": launches,
         "fig7": {p: {k: r[k] for k in ("largest_norm", "nstdev", "messages",
                                         "connected_frac", "gain")}
                  for p, r in fig7.items()}})
    return part, road_part, launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _logits_along(cfg, params, prompts, tokens):
    """Prefill ``prompts``, then decode fed ``tokens`` [B, n]: each step's
    logits over the real vocabulary, float32 [B, n, V]."""
    from repro_torch.serve import serve_step as SS
    lg, caches = SS.prefill(cfg, params, prompts)
    out = [lg[:, -1]]
    s = prompts.shape[1]
    for k in range(tokens.shape[1] - 1):
        lg, caches = SS.decode(cfg, params, tokens[:, k:k + 1], caches, s + k)
        out.append(lg[:, -1])
    return torch.stack(out, 1)[..., :cfg.vocab].float()


def _greedy_agrees(tokens, logits, rel: float) -> tuple[bool, int]:
    """(every token within ``rel`` · max |logit| of its step's largest
    logit and equal to the argmax where the top two are further apart,
    the number of steps where they are)."""
    tol = rel * float(logits.abs().max())
    chosen = logits.gather(-1, tokens.long()[..., None])[..., 0]
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    ok = bool((chosen >= top2[..., 0] - tol).all()) and torch.equal(
        tokens.long()[clear], logits.argmax(-1)[clear])
    return ok, int(clear.sum())


def phase_lm(cfg=None, dev: str = "cuda"):
    """Mamba serving at full width and depth on the card (module docstring,
    phase 6). Returns (the kernels' launches in ``generate``, the scan's
    inputs at the first and last layer of the prompt's prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.serve import serve_step as SS

    cfg = cfg or get_config(LM_ARCH)
    layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, t_init = wall(lambda: lm.init_params(cfg, gen, dev))
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    _, d_in, dt_rank = ssm_dims(cfg)
    log({"phase": "lm.init", "arch": cfg.name, "n_layers": layers,
         "d_model": cfg.d_model, "d_inner": d_in, "d_state":
             cfg.ssm.d_state, "dt_rank": dt_rank, "vocab_pad":
             lm.vocab_pad(cfg), "params": n_params, "param_count":
             cfg.param_count(), "param_bytes": sum(
                 t.numel() * t.element_size() for t in leaves),
         "wall_s": t_init, "peak_mib": peak_mib()})

    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    ops.reset_launches()
    (logits, caches), t_first = wall(lambda: SS.prefill(cfg, params,
                                                        prompts))
    require(ops.LAUNCHES["selective_scan"] == layers,
            f"prefill launched selective_scan "
            f"{ops.LAUNCHES['selective_scan']} times, not {layers}")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    require(tuple(logits.shape) == (LM_BATCH, LM_PROMPT, lm.vocab_pad(cfg)),
            f"prefill logits of shape {tuple(logits.shape)}")
    t_warm = wall(lambda: SS.prefill(cfg, params, prompts))[1]
    tok = SS.greedy_token(logits[:, -1:], cfg.vocab)

    def decode_run():
        c, t, lg = caches, tok, None
        for n in range(LM_PROMPT, LM_PROMPT + LM_NEW - 1):
            lg, c = SS.decode(cfg, params, t, c, n)
            t = SS.greedy_token(lg[:, -1:], cfg.vocab)
        return lg

    before = ops.LAUNCHES["selective_scan"]
    last, t_dec_first = wall(decode_run)
    require(ops.LAUNCHES["selective_scan"] - before == layers * (LM_NEW - 1),
            "decode did not launch selective_scan once per layer and step")
    require(bool(torch.isfinite(last).all()), "decode logits not finite")
    t_dec = wall(decode_run)[1]
    log({"phase": "lm.prefill_decode", "batch": LM_BATCH,
         "prompt_len": LM_PROMPT, "prefill_first_s": t_first,
         "prefill_warm_s": t_warm,
         "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_warm,
         "decode_steps": LM_NEW - 1,
         "decode_ms_per_step_first": 1e3 * t_dec_first / (LM_NEW - 1),
         "decode_ms_per_step": 1e3 * t_dec / (LM_NEW - 1),
         "decode_tokens_per_s": LM_BATCH * (LM_NEW - 1) / t_dec,
         "peak_mib": peak_mib()})

    # the main path: the counters from 0, one generate, read just after
    engine = SS.Engine(cfg, params, s_max=LM_PROMPT + LM_NEW)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, t_gen = wall(lambda: engine.generate(prompts, LM_NEW))
    launches = dict(ops.LAUNCHES)
    gen_peak = peak_mib()
    require(launches["selective_scan"] == layers * LM_NEW,
            f"generate launched selective_scan {launches['selective_scan']} "
            f"times, not {layers} x {LM_NEW}")
    require(tuple(out.shape) == (LM_BATCH, LM_NEW)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            "generate's tokens are not [B, n_new] ids of the vocabulary")

    # decode for token s against a prefill of s + 1 tokens; and, to show
    # the bound tells a right cache from a wrong one, decode from the conv
    # window padded as the reference's Engine.generate pads it at a prompt
    # of d_conv - 1 tokens, and from a zeroed SSM state
    full, _, _ = lm.forward_lm(cfg, params, torch.cat([prompts, tok], 1))
    want = full[:, -1].float()
    scale = float(want.abs().max())
    require(bool(torch.isfinite(full).all()), "prefill logits not finite")
    conv, h = caches["l0"]
    rel = {}
    for name, c in (("right", caches),
                    ("conv_padded", {"l0": (torch.nn.functional.pad(
                        conv, (0, 0, 0, LM_NEW)), h)}),
                    ("state_zeroed", {"l0": (conv, torch.zeros_like(h))})):
        dec, _ = SS.decode(cfg, params, tok, c, LM_PROMPT)
        require(bool(torch.isfinite(dec).all()), "decode logits not finite")
        rel[name] = float((dec[:, 0].float() - want).abs().max()) / scale
    bound = bf16_rel(layers)
    log({"phase": "lm.generate", "new_tokens": LM_NEW, "wall_s": t_gen,
         "tokens_per_s": LM_BATCH * LM_NEW / t_gen, "launches": launches,
         "peak_mib": gen_peak, "first_token_equals_prefill_argmax":
             torch.equal(out[:, :1], tok), "max_abs_logit": scale,
         "decode_vs_prefill_rel": rel, "bound_rel": bound})
    require(rel["right"] <= bound, f"decode vs prefill of s + 1 tokens: "
            f"max abs {rel['right']} x {scale} > {bound} x {scale}")
    require(min(rel["conv_padded"], rel["state_zeroed"]) > bound,
            f"a wrong cache passes the decode-vs-prefill bound: {rel}")

    # the scan's real inputs at the first and the last layer
    captured, calls, real = {}, [0], ops.selective_scan

    def capture(*args):
        if calls[0] in (0, layers - 1):
            captured[f"layer{calls[0]}"] = tuple(
                None if t is None else t.clone() for t in args)
        calls[0] += 1
        return real(*args)

    ops.selective_scan = capture
    try:
        SS.prefill(cfg, params, prompts)
    finally:
        ops.selective_scan = real
    del params, leaves, engine, logits, caches, conv, h, last, dec, full
    torch.cuda.empty_cache()
    return launches, captured


def _lm_cpu_equal():
    """falcon-mamba SMOKE with the same parameters on the card and on the
    CPU: the card's greedy tokens, and every step's logits along them."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import Engine

    cfg = get_config(LM_ARCH, smoke=True)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = lm.params_from_reference(cfg, lm.params_to_numpy(cpu), "cuda")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, 16),
                            generator=torch.Generator().manual_seed(SEED))
    toks = {dev: Engine(cfg, p, s_max=32).generate(prompts.to(dev), 8).cpu()
            for dev, p in (("cuda", card), ("cpu", cpu))}
    lg_card = _logits_along(cfg, card, prompts.cuda(), toks["cuda"].cuda())
    lg_cpu = _logits_along(cfg, cpu, prompts, toks["cuda"])
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    scale = float(lg_cpu.abs().max())
    bound = bf16_rel(cfg.n_layers)
    ok, clear = _greedy_agrees(toks["cuda"], lg_cpu, bound)
    log({"phase": "cpu_equal.lm", "arch": cfg.name, "tokens_equal":
         torch.equal(toks["cuda"], toks["cpu"]), "clear_steps": clear,
         "steps": toks["cuda"].numel(), "logits_max_abs": err,
         "max_abs_logit": scale, "logits_rel": err / scale,
         "bound_rel": bound})
    require(err <= bound * scale, f"SMOKE logits card vs CPU: max abs {err} "
            f"> {bound} x {scale}")
    require(ok, "the card's greedy tokens are not the CPU's")


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


def _exchange_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for the exchange on this plan: each live slot's value
    read once, each group's slot indices (and its pointer) read once, both
    masks read once and every slot written once."""
    kv = plan.k * plan.v_max
    live = int(plan.vmask.sum())
    rep = plan.vmask & plan.replicated
    groups = int(torch.unique(plan.local2global[rep]).numel())
    nbytes = (4 * f * live + 4 * (int(rep.sum()) + groups + 1) + 2 * kv
              + 4 * f * kv)
    return _bound(nbytes, 0)


def _exchange_plans(g, owner, plan, patched) -> dict:
    """The exchange's plans: the main path's, the patched one, a hub in
    all K partitions (a star of EXCHANGE_HUB_LEAVES leaves on a path, each
    edge owned by ``dst % K``; each leaf in two or three partitions), and
    the main path's graph and owner compiled for K + 1 partitions (the
    last one empty)."""
    from repro_torch import engine as E
    from repro_torch.core import graph
    n = EXCHANGE_HUB_LEAVES
    star = np.stack([np.zeros(n, np.int64), np.arange(1, n + 1)], 1)
    path = np.stack([np.arange(1, n), np.arange(2, n + 1)], 1)
    hub_g = graph.from_edge_array(n + 1, np.concatenate([star, path]))
    hub = E.compile_plan(hub_g, torch.where(hub_g.edge_mask, hub_g.dst % K,
                                            -2), K)
    return {"plan": plan, "patched": patched, "hub": hub,
            "empty_part": E.compile_plan(g, owner, K + 1)}


def _exchange_checks(Kn, plans, gen) -> float:
    """exchange against its plain versions on each of ``plans`` at F = 1
    and 8: bit for bit against the layout's plain walk
    (``exchange_layout_ref``) for min, add and max; against the reference
    chain (``exchange_ref``) min and max exact, add within
    EXCHANGE_ADD_ATOL, and two add calls the same bits. Returns the
    largest |kernel - chain|."""
    errs, stats = {}, {}
    for pname, p in plans.items():
        lay = Kn.exchange_layout(p)
        stats[pname] = dict(lay.stats(), build_s=wall(
            lambda: Kn.build_exchange_layout(p))[1])
        for f in (1, 8):
            shape = (p.k, p.v_max) + ((f,) if f > 1 else ())
            x = torch.rand(shape, generator=gen, device=p.device)
            inf = torch.rand(shape, generator=gen, device=p.device) < 0.2
            for combine in ("min", "add", "max"):
                key = f"{pname}.f{f}.{combine}"
                vals = torch.where(inf, float("inf"), x * 30) \
                    if combine == "min" else x
                got = Kn.exchange(p, vals, combine)
                require(torch.equal(got, Kn.exchange_layout_ref(
                    p, vals, combine)), f"exchange {key}: not its layout "
                    "walk, bit for bit")
                want = Kn.exchange_ref(p, vals, combine)
                torch.cuda.synchronize()
                errs[key] = _max_abs(got, want)
                if combine == "add":
                    require(errs[key] <= EXCHANGE_ADD_ATOL,
                            f"exchange {key}: max abs {errs[key]}")
                    require(torch.equal(Kn.exchange(p, vals, combine), got),
                            f"exchange {key}: two calls differ")
                else:
                    require(torch.equal(got, want),
                            f"exchange {key} is not exact")
            del x, inf
    log({"phase": "kernels.exchange.check", "max_abs_err": errs,
         "layout_walk_identical": True, "add_repeat_identical": True,
         "layouts": stats})
    return max(errs.values())


def _exchange_values(plan, gen, f: int, combine: str) -> torch.Tensor:
    """[K, Vmax(, F)] exchange values: in [0, 30) with ~20% +inf
    (unreached) for min, in [0, 1) for add and max."""
    shape = (plan.k, plan.v_max) + ((f,) if f > 1 else ())
    x = torch.rand(shape, generator=gen, device=plan.device)
    if combine != "min":
        return x
    return torch.where(torch.rand(shape, generator=gen, device=plan.device)
                       < 0.2, float("inf"), x * 30)


def _exchange_timing(Kn, plan, gen, times) -> dict:
    """exchange on the main path's plan at EXCHANGE_CASES: the kernel, its
    plain version and the parent's chain (``exchange_ref`` closed by the
    ``masked_update`` kernel, as the engine ran it before), device and
    eager ms; the kernel and the chain also in turns (chain, kernel,
    kernel, chain); the bound."""
    out = {}
    for label, f, combine in EXCHANGE_CASES:
        vals = _exchange_values(plan, gen, f, combine)

        def kernel():
            return Kn.exchange(plan, vals, combine)

        def chain():
            return Kn.exchange_ref(plan, vals, combine,
                                   update=Kn.masked_update)
        t = times(kernel=kernel, plain=lambda: Kn.exchange_ref(
            plan, vals, combine), library=chain)
        c1, k1 = device_ms(chain), device_ms(kernel)
        k2, c2 = device_ms(kernel), device_ms(chain)
        t["turns"] = {"library_ms": [c1, c2], "kernel_ms": [k1, k2]}
        t["bound_ms"], t["bound_by"] = _exchange_bound(plan, f)
        out[label] = t
        del vals
    log({"phase": "kernels.exchange.timing", **out})
    return out


def _lane_timing(Kn, plan, gen, times) -> dict:
    """segment_reduce and exchange (min) at the serve path's lane widths
    (SERVE_WIDTHS): [K, Emax, S] messages and [K, Vmax, S] states, each
    held exact against its plain version and timed beside its bound and a
    library call (``scatter_reduce`` amin; the parent's exchange chain)."""
    dev = plan.device
    inf = float("inf")
    rows = torch.arange(plan.k, device=dev)[:, None] * plan.v_max
    out = {"segment_reduce": {}, "exchange": {}}
    for s in SERVE_WIDTHS:
        shape = (plan.k, plan.e_max, s)
        msgs = torch.where(torch.rand(shape, generator=gen, device=dev)
                           < 0.2, inf, torch.rand(shape, generator=gen,
                                                  device=dev) * 30)
        idx = (rows + plan.edge_tgt.long()).reshape(-1, 1).expand(-1, s)
        masked = torch.where(plan.emask[:, :, None], msgs, inf).reshape(-1, s)
        ident = torch.full((plan.k * plan.v_max, s), inf, device=dev)
        require(torch.equal(Kn.segment_reduce(plan, msgs, "min"),
                            Kn.segment_reduce_ref(plan, msgs, "min")),
                f"segment_reduce min at F={s} is not exact")
        t = times(iters=10,
                  kernel=lambda: Kn.segment_reduce(plan, msgs, "min"),
                  plain=lambda: Kn.segment_reduce_ref(plan, msgs, "min"),
                  library=lambda: torch.scatter_reduce(ident, 0, idx, masked,
                                                       "amin"))
        t["bound_ms"], t["bound_by"] = _seg_bound(plan, s)
        out["segment_reduce"][f"s{s}"] = t
        del msgs, idx, masked, ident
        vals = _exchange_values(plan, gen, s, "min")
        got = Kn.exchange(plan, vals, "min")
        require(torch.equal(got, Kn.exchange_layout_ref(plan, vals, "min"))
                and torch.equal(got, Kn.exchange_ref(plan, vals, "min")),
                f"exchange min at F={s} is not exact")
        t = times(iters=10, kernel=lambda: Kn.exchange(plan, vals, "min"),
                  plain=lambda: Kn.exchange_ref(plan, vals, "min"),
                  library=lambda: Kn.exchange_ref(plan, vals, "min",
                                                  update=Kn.masked_update))
        t["bound_ms"], t["bound_by"] = _exchange_bound(plan, s)
        out["exchange"][f"s{s}"] = t
        del vals, got
    log({"phase": "kernels.lanes.timing", **out})
    return out


def _gspmm_bound(plan, f: int, per_feature: bool = False
                 ) -> tuple[float, str]:
    """Least time for gspmm on this plan: per live half-edge its neighbour
    index and its weight (4·F bytes of them with per-feature weights); per
    slot the two masks; per target ``last_slot`` and ``vmask``; per live
    append slot its target; each distinct live feature row read once; each
    output row written once. Operations: a multiply and a combine per
    feature per live half-edge."""
    kv, ke = plan.k * plan.v_max, plan.k * plan.e_max
    live = int(plan.emask.sum())
    slot = torch.arange(plan.e_max, device=plan.device)[None, :]
    append_live = int((plan.emask & (slot >= plan.csr_fill[:, None])).sum())
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    rows = int(torch.unique((base + plan.edge_nbr.long())[plan.emask]).numel())
    weight = 4 * f if per_feature else 4
    nbytes = ((4 + weight) * live + 2 * ke + 5 * kv + 4 * plan.k
              + 4 * append_live + 4 * f * rows + 4 * f * kv)
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
    the plan with no live slot). The two plans are ``dataclasses.replace``d,
    so each builds its kernels' layouts at its first call, which must not be
    inside a CUDA-graph capture: ``device_ms`` makes that call while it
    warms up, on a side stream, before it captures."""
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
                    if combine == "add":
                        require(torch.equal(Kn.gspmm(p, feats, w, combine),
                                            got),
                                f"gspmm {key}: two calls differ")
        del feats, wide
    log({"phase": "kernels.gspmm.check", "max_abs_err": errs,
         "max_rel_err": rels, "add_repeat_identical": True})
    return errs


def _gspmm_timing(Kn, plan, gen, times):
    """gspmm with add at the widths in GSPMM_WIDTHS with scalar weights,
    and at kge_score's F = 8 with per-feature weights (``feature_f8``):
    kernel, plain and (scalar weights) ``torch.sparse.mm`` device and eager
    times, the bound, and the largest hub run's own time: the kernel with
    only that run live less the kernel with no live slot (both still walk
    every target), measured HUB_REPEATS times interleaved, the median of
    the differences kept and the spread reported."""
    dev = plan.device
    a = _spmm_matrix(plan)
    hub, hub_only, empty = _hub_split(plan)
    out = {"largest_hub": hub}
    cases = [(f"f{f}", f, False) for f in GSPMM_WIDTHS] + \
        [("feature_f8", 8, True)]
    for name, f, per_feature in cases:
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        wide = torch.rand(tuple(plan.emask.shape) + (f,), generator=gen,
                          device=dev) if per_feature else None

        def call(p, fn=Kn.gspmm):
            w = wide if per_feature else p.edge_w
            return lambda: fn(p, feats, w, "add")
        fns = {"kernel": call(plan), "plain": call(plan, Kn.gspmm_ref)}
        t = {}
        if not per_feature:
            dense = feats.view(plan.k * plan.v_max, f)
            lib = torch.sparse.mm(a, dense).view(plan.k, plan.v_max, f)
            got = Kn.gspmm(plan, feats, plan.edge_w, "add")
            t["library_max_rel_vs_kernel"] = float(
                ((lib - got).abs() / got.abs().clamp(min=1e-30)).max())
            fns["library"] = lambda: torch.sparse.mm(a, dense)
            del lib, got
        iters = 20 if f <= 8 else 5
        t.update(times(iters=iters, **fns))
        pairs = [(device_ms(call(hub_only)), device_ms(call(empty)))
                 for _ in range(HUB_REPEATS)]
        t["hub_only_ms"] = [h for h, _ in pairs]
        t["empty_ms"] = [e for _, e in pairs]
        t["hub_run_ms"] = float(np.median([h - e for h, e in pairs]))
        t["bound_ms"], t["bound_by"] = _gspmm_bound(plan, f, per_feature)
        out[name] = t
        del feats, fns, wide
    lay = Kn.gspmm_layout(plan)
    out["layout"] = {"chunk_slots": lay.chunk_slots, "chunks": lay.n_chunks,
                     "units": lay.seg.n_units,
                     "split_units": int(torch.unique(
                         lay.chunks[lay.chunks[:, 5] > 1, 3]).numel()),
                     "build_s": wall(lambda: Kn.build_gspmm_layout(
                         plan, lay.seg))[1]}
    log({"phase": "kernels.gspmm.timing", **out})
    return out


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the entries where ``want`` is finite
    (0.0 if none); infinities must match exactly, which the callers check
    with ``torch.equal``."""
    fin = torch.isfinite(want.double())
    if not bool(fin.any()):
        return 0.0
    return float((got.double()[fin] - want.double()[fin]).abs().max())


def slow_ms(fn, iters: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` eager calls after one warm call
    (CUDA events), for calls of hundreds of ms, where a CUDA graph's saving
    (the host launch cost) is noise."""
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


def _flat_scan_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The yardstick DFEP's rank cumsum used before lane_cumsum: the K
    columns of an [N, K] int32 array laid end to end and scanned as one flat
    array (one device-wide scan), then each column's offset, the total of
    the columns before it, taken off."""
    n, k = x.shape
    flat = torch.cumsum(x.t().reshape(-1), 0, dtype=torch.int32).view(k, n)
    before = torch.zeros(k, dtype=torch.int32, device=x.device)
    before[1:] = flat[:-1, -1]
    return (flat - before[:, None]).t()


def _dfep_rank_inputs(g, owner):
    """DFEP's two rank-cumsum inputs on its final state: [2·e_pad, K] 0/1
    eligibility of each slot's edge for each partition (an owned edge is
    eligible for its owner only), in slot order, and [V, K] 0/1 presence of
    each vertex in each partition."""
    from repro_torch.core import dfep
    slots = dfep.build_slots(g)
    part_ids = torch.arange(K, device=g.device)
    elig = ((owner.long()[:, None] == part_ids[None, :])
            & g.edge_mask[:, None]).to(torch.int32)
    pres = torch.zeros((g.n_vertices, K), dtype=torch.int32, device=g.device)
    pres.index_add_(0, g.src.long(), elig)
    pres.index_add_(0, g.dst.long(), elig)
    return elig[slots.edge].contiguous(), (pres > 0).to(torch.int32)


def _replay_check(name: str, static_in, other, plain):
    """A device_ms ``check``: copy ``other`` into the graph's input
    ``static_in``, replay once more, and require the last call's output to
    equal ``plain(static_in)``. A new input makes look-back flags left over
    from the replays before show."""
    def check(replay, out):
        static_in.copy_(other)
        replay()
        torch.cuda.synchronize()
        require(torch.equal(out, plain(static_in)), f"{name} differs from "
                "the plain version after a graph replay")
    return check


def _lane_cumsum_section(g, owner, gen, times) -> dict:
    """lane_cumsum on DFEP's rank inputs (int32, exact against the plain
    version and the flat scan) and on float32 values in [0, 1) (within
    FLOAT_CUMSUM_RTOL of a float64 cumsum); timed on the [2·e_pad, K]
    input, each timing graph replayed once more on the input shifted by a
    row and held against the plain version."""
    from repro_torch.kernels import ops, ref
    x_slot, x_pres = _dfep_rank_inputs(g, owner)
    shapes, err = {}, 0.0
    for name, x in (("slots", x_slot), ("presence", x_pres)):
        got = ops.lane_cumsum(x)
        want = ref.cumsum_lanes(x)
        torch.cuda.synchronize()
        err = max(err, _max_abs(got, want))
        require(torch.equal(got, want), f"lane_cumsum {name} is not exact")
        require(torch.equal(got, _flat_scan_cumsum(x)),
                f"lane_cumsum {name} differs from the flat scan")
        shapes[name] = list(x.shape)
    xf = torch.rand(x_slot.shape, generator=gen, device=x_slot.device)
    gotf = ops.lane_cumsum(xf).double()
    wantf = torch.cumsum(xf.double(), 0)
    rel_f = float(((gotf - wantf).abs() / wantf.clamp(min=1.0)).max())
    plain_rel_f = float(((ref.cumsum_lanes(xf).double() - wantf).abs()
                         / wantf.clamp(min=1.0)).max())
    require(rel_f <= FLOAT_CUMSUM_RTOL, f"lane_cumsum float32: max rel "
            f"{rel_f} > {FLOAT_CUMSUM_RTOL}")
    del xf, gotf, wantf
    s, k = x_slot.shape
    static = {"slots": x_slot.clone(), "presence": x_pres.clone()}
    checks = {n: _replay_check(f"lane_cumsum {n}", x, torch.roll(x, 1, 0),
                               ref.cumsum_lanes) for n, x in static.items()}
    t = times(kernel=lambda: ops.lane_cumsum(static["slots"]),
              flat_scan=lambda: _flat_scan_cumsum(x_slot),
              check=checks["slots"])
    t["presence_kernel_ms"] = device_ms(
        lambda: ops.lane_cumsum(static["presence"]),
        check=checks["presence"])
    # torch.cumsum down dim 0 runs K serial scans (~0.7 s a call here)
    t["plain_ms"] = slow_ms(lambda: ref.cumsum_lanes(x_slot))
    t["library_ms"] = slow_ms(lambda: torch.cumsum(x_slot, 0))
    t["bound_ms"], t["bound_by"] = _bound(8 * s * k, s * k)
    out = {"shapes": shapes, "max_abs_err": err, "graph_replay_exact": True,
           "float32_max_rel_vs_f64": rel_f,
           "plain_float32_max_rel_vs_f64": plain_rel_f, **t}
    log({"phase": "kernels.lane_cumsum", **out})
    return out


def _frontier_min_timing(state, member, times, name: str) -> dict:
    """Device and eager ms of frontier_min, its plain version and
    ``torch.amin`` of the pre-masked state, the timing graph replayed once
    more on the state reversed along V and held against the plain version;
    with the bound: the member mask read, the state read where a member
    needs it (the kernel skips the rest) and the output written."""
    from repro_torch.kernels import ops, ref
    k, v = state.shape
    static = state.clone()
    masked = torch.where(member, state, float("inf"))
    t = times(kernel=lambda: ops.frontier_min(static, member),
              plain=lambda: ref.kreduce_min(state, member),
              library=lambda: torch.amin(masked, 0),
              check=_replay_check(f"frontier_min {name}", static,
                                  state.flip(1),
                                  lambda st: ref.kreduce_min(st, member)))
    members = int(member.sum())
    t["bound_ms"], t["bound_by"] = _bound(k * v + 4 * members + 4 * v,
                                          members)
    return t


def _frontier_min_section(part, gen, times) -> dict:
    """frontier_min on a [K, V] state with ~20% +inf, the real member mask,
    and the same with vertex 0 in no partition; float32 and bfloat16;
    exact against the plain version. Timed there and at multi-source
    SSSP's [K, N_SOURCES·V] with its member mask (each row's mask repeated
    per source), which is checked exact too."""
    from repro_torch.kernels import ops, ref
    dev = part.device
    k, v = part.k, part.n_vertices
    state = torch.rand((k, v), generator=gen, device=dev) * 30
    state = torch.where(torch.rand((k, v), generator=gen, device=dev) < 0.2,
                        float("inf"), state)
    lonely = part.member.clone()
    lonely[:, 0] = False
    err = 0.0
    for name, member in (("member", part.member), ("no_member_col0", lonely)):
        for dtype in (torch.float32, torch.bfloat16):
            st = state.to(dtype)
            got = ops.frontier_min(st, member)
            want = ref.kreduce_min(st, member)
            torch.cuda.synchronize()
            err = max(err, _max_abs(got, want))
            require(torch.equal(got, want),
                    f"frontier_min {name} {dtype} is not exact")
    require(bool(torch.isinf(ops.frontier_min(state, lonely)[0])),
            "frontier_min: a column with no member is not +inf")
    t = _frontier_min_timing(state, part.member, times, "[K, V]")
    member_sv = (part.member[:, None, :].expand(k, N_SOURCES, v)
                 .reshape(k, N_SOURCES * v))
    state_sv = torch.rand((k, N_SOURCES * v), generator=gen, device=dev) * 30
    state_sv = torch.where(member_sv, state_sv, float("inf"))
    got = ops.frontier_min(state_sv, member_sv)
    require(torch.equal(got, ref.kreduce_min(state_sv, member_sv)),
            "frontier_min at the multi-source shape is not exact")
    t_sv = _frontier_min_timing(state_sv, member_sv, times, "[K, S·V]")
    out = {"shape": [k, v], "max_abs_err": err, "graph_replay_exact": True,
           **t, "multi_source": {"shape": [k, N_SOURCES * v], **t_sv}}
    log({"phase": "kernels.frontier_min", **out})
    return out


def _minplus_bound(mask: torch.Tensor, rows: int,
                   replicas: int = 1) -> tuple[float, str]:
    """minplus_sweep's bound: the state read and written once, every mask
    byte and each live edge's two endpoints (int32) read once (the
    replicas share one edge list), and two candidates per live edge and
    replica."""
    live = int(mask.sum())
    return _bound(8 * rows + int(mask.numel()) + 8 * live,
                  2 * live * replicas)


def _minplus_section(g, part, road_part, gen, times, sssp_state) -> dict:
    """minplus_sweep at its four shapes: ETSCH's flat [K·V] state over its
    K·e_max edge slots (the table's), the whole graph's [V], multi-source
    SSSP's [K·N_SOURCES·V] under the flat layout with N_SOURCES replicas,
    and usroads' flat [K·V]; costs 1 and 0, ~5% of the live edges masked
    out, ~20% of the values +inf; exact against the plain version with the
    memoised layout and, at one replica, without one (the wrapper builds
    it). The layouts' build time is logged as set-up. Timed at cost 1 on
    each shape, each timing graph replayed once more on a new state and
    held exact, and on SSSP's fixed point (``sssp_state`` on every
    member), where no candidate wins."""
    from repro_torch.core import algorithms as A
    from repro_torch.kernels import ops, ref
    dev = part.device
    kv = part.k * part.n_vertices

    def state(n, member=None):
        x = torch.rand(n, generator=gen, device=dev) * 30
        x = torch.where(torch.rand(n, generator=gen, device=dev) < 0.2,
                        float("inf"), x)
        return x if member is None else torch.where(member, x, float("inf"))

    def thin(mask):
        return mask & (torch.rand(mask.shape, generator=gen, device=dev)
                       >= 0.05)

    build = {}
    for name, make in (
            ("etsch", lambda: ops.minplus_layout(
                part.flat_src, part.flat_dst, kv, groups=part.k)),
            ("graph", lambda: ops.minplus_layout(g.src, g.dst,
                                                 g.n_vertices)),
            ("usroads", lambda: ops.minplus_layout(
                road_part.flat_src, road_part.flat_dst,
                road_part.k * road_part.n_vertices, groups=road_part.k))):
        lay, t = wall(make)
        build[name] = {"wall_s": t, "tile_rows": lay.tile_rows,
                       "half_edges": int(lay.half_edges.shape[0]),
                       "short_rows": int(lay.entries.shape[0])
                       - sum(lay.counts),
                       "units": list(lay.counts)}
    log({"phase": "kernels.minplus_sweep.layout", **build})
    member_sv = part.member[:, None, :].expand(part.k, N_SOURCES,
                                               part.n_vertices).reshape(-1)
    cases = {
        "etsch": (state(kv, part.member.reshape(-1)), part.flat_src,
                  part.flat_dst, thin(part.flat_mask), part.minplus_layout),
        "graph": (state(g.n_vertices), g.src, g.dst, thin(g.edge_mask),
                  A._graph_layout(g)),
        "multi_source": (state(kv * N_SOURCES, member_sv), part.flat_src,
                         part.flat_dst, thin(part.flat_mask),
                         part.minplus_layout.with_replicas(N_SOURCES)),
        "usroads": (state(road_part.k * road_part.n_vertices,
                          road_part.member.reshape(-1)), road_part.flat_src,
                    road_part.flat_dst, thin(road_part.flat_mask),
                    road_part.minplus_layout),
    }

    def plain(dist, src, dst, mask, lay, cost=1.0):
        return ref.minplus_relax(dist, *lay.replicate(src, dst, mask), cost)

    err = 0.0
    for name, (dist, src, dst, mask, lay) in cases.items():
        for cost in (1.0, 0.0):
            want = plain(dist, src, dst, mask, lay, cost)
            got = [ops.minplus_sweep(dist, src, dst, mask, cost, layout=lay)]
            if lay.replicas == 1:
                got.append(ops.minplus_sweep(dist, src, dst, mask, cost))
            torch.cuda.synchronize()
            for out in got:
                err = max(err, _max_abs(out, want))
                require(torch.equal(out, want),
                        f"minplus_sweep {name} cost {cost} is not exact")
    out = {}
    for name, (dist, src, dst, mask, lay) in cases.items():
        static = dist.clone()
        check = _replay_check(
            f"minplus_sweep {name}", static, state(dist.numel()),
            lambda d: plain(d, src, dst, mask, lay))
        kernel = lambda: ops.minplus_sweep(static, src, dst, mask,
                                           layout=lay)
        if name == "etsch":
            s64, d64 = src.long(), dst.long()
            cu = torch.where(mask, dist[s64] + 1.0, float("inf"))
            cv = torch.where(mask, dist[d64] + 1.0, float("inf"))
            t = times(kernel=kernel,
                      plain=lambda: plain(dist, src, dst, mask, lay),
                      library=lambda: dist.scatter_reduce(
                          0, d64, cu, "amin").scatter_reduce_(
                              0, s64, cv, "amin"), check=check)
        else:
            t = {"kernel_ms": device_ms(kernel, check=check)}
        t["bound_ms"], t["bound_by"] = _minplus_bound(
            mask, lay.n_rows * lay.replicas, lay.replicas)
        out[name] = {"rows": lay.n_rows * lay.replicas,
                     "edge_slots": int(mask.numel()) * lay.replicas,
                     "live_edges": int(mask.sum()) * lay.replicas, **t}
    dist, src, dst, mask, lay = cases["etsch"]
    fixed = torch.where(part.member, sssp_state[None, :],
                        float("inf")).reshape(-1)
    require(torch.equal(ops.minplus_sweep(fixed, src, dst, part.flat_mask,
                                          layout=lay), fixed),
            "SSSP's fixed point moved under a sweep")
    out["etsch"]["fixpoint_kernel_ms"] = device_ms(lambda: ops.minplus_sweep(
        fixed, src, dst, part.flat_mask, layout=lay))
    res = {"max_abs_err": err, "graph_replay_exact": True, **out}
    log({"phase": "kernels.minplus_sweep", **res})
    return res


#: Hopper's SFU rate for ex2: results per clock per SM (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0).
EX2_PER_CLOCK_PER_SM = 16


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return 1e6 * float(out.strip().splitlines()[0])


def _scan_bound(b: int, s: int, d: int, n: int, h0: bool):
    """selective_scan's bound terms in ms, as ``(ms, by, terms)`` with
    ``by`` "bytes" or "operations": x, dt, B, C, A and D read once, h0
    read where it is given, y and h_last written once (bytes); 6 float32
    operations per state element and step (flops); and one exp per state
    element and step at EX2_PER_CLOCK_PER_SM on every SM at the maximum SM
    clock (exps). The larger of flops and exps is the operations term."""
    elems = b * s * d * n
    nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + d
                  + b * d * n * (2 if h0 else 1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "flops_ms": 1e3 * 6 * elems / FP32_FLOPS,
             "exps_ms": 1e3 * elems / (EX2_PER_CLOCK_PER_SM * sms
                                       * _sm_clock_hz()),
             "exps": elems, "sms": sms}
    ops_ms = max(terms["flops_ms"], terms["exps_ms"])
    terms["binding"] = ("bytes" if terms["bytes_ms"] >= ops_ms else
                        "exps" if terms["exps_ms"] >= terms["flops_ms"]
                        else "flops")
    if terms["bytes_ms"] >= ops_ms:
        return terms["bytes_ms"], "bytes", terms
    return ops_ms, "operations", terms


def _selective_scan_section(captured, gen, times) -> dict:
    """selective_scan against its plain loop, y and h_last within SCAN_REL
    of their largest |value|: seeded inputs at the prefill shape (the
    captured layers' [B, S, Di] and N; the JAX
    kernel tests' distributions) from a zero and a random h0, S = 1 from a
    random h0 (decode), and the lm phase's captured layer inputs; timed at
    the prefill shape from a zero state, as prefill calls it, and at S = 1
    from h0, as decode calls it; bounds from :func:`_scan_bound`."""
    from repro_torch import cuda_build
    from repro_torch.kernels import ops, ref
    x0, a0 = captured["layer0"][0], captured["layer0"][4]
    (b, s, d), n, dev = x0.shape, a0.shape[1], x0.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, bb, cc = randn(b, s, d), randn(b, s, n, scale=0.5), \
        randn(b, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    a = torch.exp(randn(d, n, scale=0.3))
    dsk, h0 = randn(d), randn(b, d, n)
    cases = {"prefill": (x, dt, bb, cc, a, dsk, None),
             "prefill_h0": (x, dt, bb, cc, a, dsk, h0),
             "decode": (x[:, :1].contiguous(), dt[:, :1].contiguous(),
                        bb[:, :1].contiguous(), cc[:, :1].contiguous(), a,
                        dsk, h0), **captured}
    err, rel = {}, {}
    for name, args in cases.items():
        got = ops.selective_scan(*args)
        want = ref.selective_scan_ref(*args)
        torch.cuda.synchronize()
        for part, g, w in zip(("y", "h_last"), got, want):
            e = float((g - w).abs().max())
            err[f"{name}.{part}"] = e
            rel[f"{name}.{part}"] = e / float(w.abs().max())
            require(bool(torch.isfinite(g).all()) and e <= SCAN_REL * float(
                w.abs().max()), f"selective_scan {name} {part}: max abs {e}"
                f" > {SCAN_REL} x {float(w.abs().max())}")
    log({"phase": "kernels.selective_scan.check", "max_abs_err": err,
         "max_rel_err": rel, "captured_shapes": {
             k: list(v[0].shape) for k, v in captured.items()}})
    prefill = cases["prefill"]
    t = times(kernel=lambda: ops.selective_scan(*prefill))
    t["plain_ms"] = slow_ms(lambda: ref.selective_scan_ref(*prefill))
    t["decode_kernel_ms"] = device_ms(lambda: ops.selective_scan(
        *cases["decode"]))
    t["decode_plain_ms"] = device_ms(lambda: ref.selective_scan_ref(
        *cases["decode"]))
    terms = {"prefill": _scan_bound(b, s, d, n, h0=False),
             "decode": _scan_bound(b, 1, d, n, h0=True)}
    t["bound_ms"], t["bound_by"] = terms["prefill"][:2]
    t["decode_bound_ms"], t["decode_bound_by"] = terms["decode"][:2]
    out = {"shape": [b, s, d, n], "max_abs_err": max(err.values()),
           "lanes_per_channel": cuda_build.query("selective_scan_lanes")(n),
           "bound_terms": {k: v[2] for k, v in terms.items()}, **t}
    log({"phase": "kernels.selective_scan", **out})
    return out


def phase_kernels(plan, launches, gnn_launches, g, owner, part, road_part,
                  etsch_launches, sssp_state, lm_launches, lm_inputs,
                  serve_launches):
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
            again = Kn.segment_reduce(p, msgs, combine)
            require(torch.equal(again, got),
                    "segment_reduce add: two calls differ")
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
    errs, rels, layouts = {}, {}, {}
    for name, p in (("plan", plan), ("patched", patched)):
        for combine, msgs in (("min", dist), ("max", finite),
                              ("add", finite)):
            key = f"{name}.{combine}"
            errs[key], rels[key] = check_seg(p, msgs, combine)
        # the layout (built with the plan, or at the patched plan's first
        # call above), built again to time it
        lay, secs = wall(lambda: Kn.build_segment_layout(p))
        layouts[name] = dict(lay.stats(), build_s=secs)
    log({"phase": "kernels.segment_reduce.check", "max_abs_err": errs,
         "max_rel_err": rels, "add_repeat_identical": True,
         "layout": layouts,
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
    ex_err = _exchange_checks(Kn, _exchange_plans(g, owner, plan, patched),
                              gen)

    # timing at the main path's shapes
    masked = {c: torch.where(plan.emask, m, Kn._IDENTITY[c]).reshape(-1)
              for c, m in (("min", dist), ("add", finite))}
    ident = {c: torch.full((plan.k * plan.v_max,), Kn._IDENTITY[c],
                           device=dev) for c in masked}
    def times(iters: int = 20, check=None, **fns):
        """Device ms (CUDA graph) and eager ms (with host launch cost);
        ``check`` goes to the kernel's device_ms."""
        out = {f"{k}_ms": device_ms(f, iters=iters,
                                    check=check if k == "kernel" else None)
               for k, f in fns.items()}
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
    ex_t = _exchange_timing(Kn, plan, gen, times)
    lanes_t = _lane_timing(Kn, plan, gen, times)
    gs_err = _gspmm_checks(Kn, plan, patched, gen)
    gs_t = _gspmm_timing(Kn, plan, gen, times)
    lc = _lane_cumsum_section(g, owner, gen, times)
    fm = _frontier_min_section(part, gen, times)
    mp = _minplus_section(g, part, road_part, gen, times, sssp_state)
    ss = _selective_scan_section(lm_inputs, gen, times)

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
         "combine": "min", "shape": [plan.k, plan.e_max],
         "add_ms": seg_t["add"]["kernel_ms"],
         "add_plain_ms": seg_t["add"]["plain_ms"],
         "add_library_ms": seg_t["add"]["library_ms"],
         "layout": layouts["plan"],
         "serve_launches": serve_launches["segment_reduce"],
         "lanes": lanes_t["segment_reduce"]},
        {"name": "exchange", "route": "cuda",
         "source": "src/repro_torch/csrc/replica_exchange.cu",
         "replaces": "src/repro/engine/kernels.py:394",
         "launches": launches["exchange"],
         "launches_gnn": gnn_launches["exchange"], "max_abs_err": ex_err,
         "ms": ex_t["f1_min"]["kernel_ms"],
         "plain_ms": ex_t["f1_min"]["plain_ms"],
         "bound_ms": ex_t["f1_min"]["bound_ms"],
         "bound_by": ex_t["f1_min"]["bound_by"],
         "library_ms": ex_t["f1_min"]["library_ms"],
         "library": "the parent's exchange chain: where, full, "
                    "scatter_reduce_, masked_update",
         "combine": "min", "shape": [plan.k, plan.v_max],
         **{label: {k: ex_t[label][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "kernel_eager_ms", "library_eager_ms", "turns")}
            for label, _, _ in EXCHANGE_CASES},
         "layout": dict(Kn.exchange_layout(plan).stats()),
         "serve_launches": serve_launches["exchange"],
         "lanes": lanes_t["exchange"],
         # the glob-form update, kept for a cross-device exchange; no
         # single-device path launches it
         "masked_update": {
             "source": "src/repro_torch/csrc/masked_update.cu",
             "launches": launches["masked_update"],
             "launches_gnn": gnn_launches["masked_update"],
             "max_abs_err": mu_err, "ms": mu_t["kernel_ms"],
             "plain_ms": mu_t["plain_ms"], "bound_ms": mu_bound,
             "bound_by": mu_by, "library_ms": None,
             "f8": {k: mu8_t[k] for k in (
                 "kernel_ms", "plain_ms", "bound_ms", "bound_by")}}},
        {"name": "gspmm", "route": "cuda",
         "source": "src/repro_torch/csrc/gspmm.cu",
         "replaces": "src/repro/engine/kernels.py:233",
         "launches": gnn_launches["gspmm"],
         "serve_launches": serve_launches["gspmm"],
         "max_abs_err": gs_err["plan.f8.scalar.add"],
         "ms": gs_t["f8"]["kernel_ms"], "plain_ms": gs_t["f8"]["plain_ms"],
         "bound_ms": gs_t["f8"]["bound_ms"],
         "bound_by": gs_t["f8"]["bound_by"],
         "library_ms": gs_t["f8"]["library_ms"],
         "combine": "add", "shape": [plan.k, plan.e_max, 8],
         "empty_ms": float(np.median(gs_t["f8"]["empty_ms"])),
         "hub_run_ms": gs_t["f8"]["hub_run_ms"],
         **{name: dict({k: gs_t[name][k] for k in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by", "hub_run_ms")},
             library_ms=gs_t[name].get("library_ms"),
             empty_ms=float(np.median(gs_t[name]["empty_ms"])))
            for name in ("f128", "feature_f8")},
         "layout": gs_t["layout"]},
        {"name": "lane_cumsum", "route": "cuda",
         "source": "src/repro_torch/csrc/lane_cumsum.cu",
         "replaces": "src/repro/kernels/lane_cumsum.py:24",
         "launches": launches["lane_cumsum"], "max_abs_err": lc["max_abs_err"],
         "ms": lc["kernel_ms"], "plain_ms": lc["plain_ms"],
         "bound_ms": lc["bound_ms"], "bound_by": lc["bound_by"],
         "library_ms": lc["library_ms"], "flat_scan_ms": lc["flat_scan_ms"],
         "shape": lc["shapes"]["slots"],
         "presence_ms": lc["presence_kernel_ms"]},
        {"name": "frontier_min", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_min.cu",
         "replaces": "src/repro/kernels/frontier_min.py:20",
         "launches": etsch_launches["frontier_min"],
         "max_abs_err": fm["max_abs_err"],
         "ms": fm["kernel_ms"], "plain_ms": fm["plain_ms"],
         "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
         "library_ms": fm["library_ms"], "shape": fm["shape"],
         "multi_source": {key: fm["multi_source"][key] for key in (
             "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")}},
        {"name": "minplus_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/minplus_sweep.cu",
         "replaces": "src/repro/kernels/minplus_sweep.py:28",
         "launches": etsch_launches["minplus_sweep"],
         "launches_by_rows": etsch_launches["minplus_by_rows"],
         "max_abs_err": mp["max_abs_err"],
         "ms": mp["etsch"]["kernel_ms"], "plain_ms": mp["etsch"]["plain_ms"],
         "bound_ms": mp["etsch"]["bound_ms"],
         "bound_by": mp["etsch"]["bound_by"],
         "library_ms": mp["etsch"]["library_ms"],
         "shape": [mp["etsch"]["rows"], mp["etsch"]["edge_slots"]],
         "fixpoint_ms": mp["etsch"]["fixpoint_kernel_ms"],
         **{name: {k: mp[name][k] for k in (
             "rows", "edge_slots", "kernel_ms", "bound_ms", "bound_by")}
            for name in ("graph", "multi_source", "usroads")}},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:28",
         "launches": lm_launches["selective_scan"],
         "max_abs_err": ss["max_abs_err"],
         "ms": ss["kernel_ms"], "plain_ms": ss["plain_ms"],
         "bound_ms": ss["bound_ms"], "bound_by": ss["bound_by"],
         "library_ms": None, "eager_ms": ss["kernel_eager_ms"],
         "shape": ss["shape"], "decode_ms": ss["decode_kernel_ms"],
         "decode_plain_ms": ss["decode_plain_ms"],
         "decode_bound_ms": ss["decode_bound_ms"],
         "decode_bound_by": ss["decode_bound_by"],
         "lanes_per_channel": ss["lanes_per_channel"],
         "bound_terms": ss["bound_terms"]},
    ]}


def phase_cpu_equal():
    from repro_torch.core import algorithms as A
    from repro_torch.core import dfep, etsch, graph, metrics
    from repro_torch import engine as E

    out, starts, ids = {}, None, None
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
        if ids is None:      # the same CC ids on both devices
            ids = np.random.default_rng(SEED).permutation(g.n_vertices)
        part = etsch.compile_partitioning(g, owner, K, device=dev)
        es = A.etsch_sssp(part, 0)
        ec = A.etsch_cc(part, ids=ids)
        m = metrics.evaluate(g, owner, K, part=part)
        out[dev] = (owner.cpu(), info["rounds"], r.state.cpu(), r.row(),
                    time.perf_counter() - t0,
                    {"sssp": (es.state.cpu(), es.supersteps, es.local_iters),
                     "cc": (ec.state.cpu(), ec.supersteps, ec.local_iters)},
                    m.row())
    require(torch.equal(out["cuda"][0], out["cpu"][0]),
            "DFEP owner differs between card and CPU")
    require(out["cuda"][1] == out["cpu"][1], "DFEP rounds differ")
    require(torch.equal(out["cuda"][2], out["cpu"][2]), "SSSP differs")
    require(out["cuda"][3] == out["cpu"][3], "SSSP counters differ")
    for name in ("sssp", "cc"):
        (sa, *ca), (sb, *cb) = out["cuda"][5][name], out["cpu"][5][name]
        require(torch.equal(sa, sb), f"etsch_{name} differs")
        require(ca == cb, f"etsch_{name} counters differ: {ca} vs {cb}")
    require(out["cuda"][6] == out["cpu"][6], f"metrics differ: "
            f"{out['cuda'][6]} vs {out['cpu'][6]}")
    log({"phase": "cpu_equal", "scale": CPU_CHECK_SCALE, "rounds":
         out["cuda"][1], "sssp": out["cuda"][3],
         "etsch": {n: c[1:] for n, c in out["cuda"][5].items()},
         "metrics": out["cuda"][6], "wall_s_cuda": out["cuda"][4],
         "wall_s_cpu": out["cpu"][4]})


def main() -> int:
    card = phase_device()
    g, owner, plan, launches, sssp_state = phase_main()
    gnn_launches = phase_gnn(g, plan)
    serve = phase_serve(g, owner)
    part, road_part, etsch_launches = phase_etsch(g, owner, plan,
                                                  sssp_state)
    lm_launches, lm_inputs = phase_lm()
    kernel_line = phase_kernels(plan, launches, gnn_launches, g, owner, part,
                                road_part, etsch_launches, sssp_state,
                                lm_launches, lm_inputs, serve["launches"])
    del lm_inputs
    phase_cpu_equal()
    _lm_cpu_equal()
    print(card, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
