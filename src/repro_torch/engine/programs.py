"""Graph programs expressed against the engine API (PyTorch), the
counterparts of ``repro.engine.programs``:

  * SSSP       — unit-weight shortest paths (paper Algorithm 1),
  * WCC        — connected components via min-label epidemic (Algorithm 2;
                 labels are vertex ids),
  * PageRank   — partial in-flow sums per partition, completed across the
                 cut each superstep (§III sketch),
  * wsssp      — weighted shortest paths over the plan's per-half-edge
                 content-hash weights (``plan.edge_w``, the ``edge`` hook),
  * BFS        — hop levels with -1.0 marking unreachable vertices,
  * labelprop  — min-label propagation over an external [V] label plane
                 (vertex property channel),
  * ppr        — personalized PageRank with an external teleport vector,
  * gcn_layer  — one GCN layer forward pass ``(D^-1/2 A_w D^-1/2 X) W``
                 over [V, F] feature planes through ``gspmm`` (the
                 ``edge_mul`` hook),
  * kge_score  — DistMult-style triple scoring over entity/relation
                 embedding channels, accumulated per vertex.

Programs are module-level constants; per-query values (source vertex,
degree vector, channel planes) travel in the ``ctx`` dict.
``multi_source_sssp`` answers a batch of sources in one superstep loop
(``Engine.run_batched``), the serving-oriented batched-query path.

Every program registers once in ``engine.registry`` at the bottom of this
module, through the same public ``registry.register`` call user programs
use, with the reference's params, resources, roles and tolerances; the
oracles are the port's own (``core/algorithms``). The serving stack
(``repro_torch.gserve``) derives request validation, batching, caching and
dispatch from those entries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import algorithms as _alg
from . import registry
from .kernels import gather_edge_channel, gather_vertex_channel
from .runtime import EdgeProgram, Engine, EngineResult
from .state import StateSpec

INF = float("inf")
DAMPING = 0.85


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------

def _sssp_prepare(plan, kw):
    # a batched dispatch hands each lane its source as a 0-d tensor
    src = kw["source"]
    return {"source": src if isinstance(src, torch.Tensor) else int(src)}


def _sssp_init(plan, ctx):
    hit = plan.vmask & (plan.local2global == ctx["source"])
    return torch.where(hit, 0.0, INF).to(torch.float32)


def _sssp_pre(state, ctx):
    return state + 1.0


def _min_apply(old, agg, ctx):
    return torch.minimum(old, agg)


def _sssp_finalize(glob, present, plan, ctx):
    iota = torch.arange(plan.n_vertices, device=glob.device)
    isolated = torch.where(iota == ctx["source"], 0.0, INF).to(torch.float32)
    return torch.where(present, glob, isolated)


def _sssp_warm(plan, prev, ctx):
    """Warm start from a previous epoch's [V] distances (valid after
    insertions only: old distances are upper bounds; +inf entries mean
    "no prior information")."""
    local = torch.where(plan.vmask, prev[plan.index64("local2global")], INF)
    return torch.minimum(_sssp_init(plan, ctx), local)


SSSP = EdgeProgram(
    name="sssp", mode="replica", combine="min",
    prepare=_sssp_prepare, init=_sssp_init, pre=_sssp_pre, apply=_min_apply,
    finalize=_sssp_finalize, local_fixpoint=True, warm_init=_sssp_warm)


# ---------------------------------------------------------------------------
# WCC (min-label propagation; labels = vertex ids, matching reference_cc)
# ---------------------------------------------------------------------------

def _wcc_prepare(plan, kw):
    # labels live in float32 state; ids above 2^24 would collide silently
    if plan.n_vertices >= 2 ** 24:
        raise ValueError("WCC float32 labels need n_vertices < 2**24")
    return {}


def _wcc_init(plan, ctx):
    return torch.where(plan.vmask, plan.local2global.to(torch.float32), INF)


def _wcc_pre(state, ctx):
    return state


def _wcc_finalize(glob, present, plan, ctx):
    own = torch.arange(plan.n_vertices, dtype=torch.float32,
                       device=glob.device)
    return torch.where(present, glob, own)


WCC = EdgeProgram(
    name="wcc", mode="replica", combine="min",
    prepare=_wcc_prepare, init=_wcc_init, pre=_wcc_pre, apply=_min_apply,
    finalize=_wcc_finalize, local_fixpoint=True)


# ---------------------------------------------------------------------------
# PageRank (partial aggregation across the cut each superstep)
# ---------------------------------------------------------------------------

def _degrees(plan, kw) -> torch.Tensor:
    """The query's [V] degree vector as float32, clamped at 1."""
    deg = torch.as_tensor(kw["degrees"], device=plan.device)
    return deg.to(torch.float32).clamp(min=1.0)


def _plane(plan, values) -> torch.Tensor:
    """A caller's channel plane as float32 on the plan's device."""
    return torch.as_tensor(values, dtype=torch.float32, device=plan.device)


def _pr_prepare(plan, kw):
    deg = _degrees(plan, kw)
    return {"deg_local": deg[plan.index64("local2global")],
            "inv_v": torch.tensor(1.0 / plan.n_vertices, dtype=torch.float32,
                                  device=plan.device)}


def _pr_init(plan, ctx):
    return torch.where(plan.vmask, 1.0 / plan.n_vertices, 0.0).to(
        torch.float32)


def _pr_pre(state, ctx):
    return state / ctx["deg_local"]


def _pr_apply(old, inflow, ctx):
    return (1.0 - DAMPING) * ctx["inv_v"] + DAMPING * inflow


def _pr_finalize(glob, present, plan, ctx):
    # a vertex in no partition has no edges: its rank is the teleport term
    teleport = torch.tensor((1.0 - DAMPING) / plan.n_vertices,
                            dtype=torch.float32, device=glob.device)
    return torch.where(present, glob, teleport)


PAGERANK = EdgeProgram(
    name="pagerank", mode="partial", combine="add",
    prepare=_pr_prepare, init=_pr_init, pre=_pr_pre,
    apply=_pr_apply, finalize=_pr_finalize,
    local_fixpoint=False, default_supersteps=30)


# ---------------------------------------------------------------------------
# Weighted SSSP — per-half-edge weights (plan.edge_w, a content hash of the
# endpoints) through the ``edge`` hook and the same segment reduce.
# ---------------------------------------------------------------------------

def _ident_pre(state, ctx):
    return state


def _wsssp_edge(msgs, plan, ctx):
    return msgs + plan.edge_w


WEIGHTED_SSSP = EdgeProgram(
    name="wsssp", mode="replica", combine="min",
    prepare=_sssp_prepare, init=_sssp_init, pre=_ident_pre,
    apply=_min_apply, finalize=_sssp_finalize, local_fixpoint=True,
    edge=_wsssp_edge, warm_init=_sssp_warm)


# ---------------------------------------------------------------------------
# BFS hop levels — unit costs through the ``edge`` hook; unreachable
# vertices are finalized to -1.0, which warm_init maps back to +inf.
# ---------------------------------------------------------------------------

def _bfs_edge(msgs, plan, ctx):
    return msgs + 1.0


def _bfs_finalize(glob, present, plan, ctx):
    d = _sssp_finalize(glob, present, plan, ctx)
    return torch.where(torch.isinf(d), -1.0, d)


def _bfs_warm(plan, prev, ctx):
    # a vertex unreachable before an insert may be reachable now
    return _sssp_warm(plan, torch.where(prev < 0.0, INF, prev), ctx)


BFS = EdgeProgram(
    name="bfs", mode="replica", combine="min",
    prepare=_sssp_prepare, init=_sssp_init, pre=_ident_pre,
    apply=_min_apply, finalize=_bfs_finalize, local_fixpoint=True,
    edge=_bfs_edge, warm_init=_bfs_warm)


# ---------------------------------------------------------------------------
# Label propagation over an external label plane (vertex property channel):
# every vertex converges to the smallest label in its component.
# ---------------------------------------------------------------------------

def _lp_prepare(plan, kw):
    lab = _plane(plan, kw["labels"])
    if lab.ndim == 1:
        lab = lab[:, None]
    return {"labels_glob": lab[:, 0],
            "labels_local": gather_vertex_channel(plan, lab)[:, :, 0]}


def _lp_init(plan, ctx):
    return torch.where(plan.vmask, ctx["labels_local"], INF)


def _lp_warm(plan, prev, ctx):
    # labels only shrink as edges arrive: a previous result is an upper
    # bound after insert-only patches, as for SSSP
    local = torch.where(plan.vmask, prev[plan.index64("local2global")], INF)
    return torch.minimum(_lp_init(plan, ctx), local)


def _lp_finalize(glob, present, plan, ctx):
    return torch.where(present, glob, ctx["labels_glob"])


LABELPROP = EdgeProgram(
    name="labelprop", mode="replica", combine="min",
    prepare=_lp_prepare, init=_lp_init, pre=_wcc_pre, apply=_min_apply,
    finalize=_lp_finalize, local_fixpoint=True, warm_init=_lp_warm)


# ---------------------------------------------------------------------------
# Personalized PageRank — rank <- (1-d)*p + d*inflow with an external
# teleport vector p (vertex property channel).
# ---------------------------------------------------------------------------

def _ppr_prepare(plan, kw):
    p = _plane(plan, kw["personalization"])
    if p.ndim == 1:
        p = p[:, None]
    return {"p_glob": p[:, 0],
            "p_local": gather_vertex_channel(plan, p)[:, :, 0],
            "deg_local": _degrees(plan, kw)[plan.index64("local2global")]}


def _ppr_init(plan, ctx):
    return torch.where(plan.vmask, ctx["p_local"], 0.0)


def _ppr_apply(old, inflow, ctx):
    return (1.0 - DAMPING) * ctx["p_local"] + DAMPING * inflow


def _ppr_finalize(glob, present, plan, ctx):
    # a vertex in no partition has no edges: rank settles at its teleport
    return torch.where(present, glob, (1.0 - DAMPING) * ctx["p_glob"])


PPR = EdgeProgram(
    name="ppr", mode="partial", combine="add",
    prepare=_ppr_prepare, init=_ppr_init, pre=_pr_pre,
    apply=_ppr_apply, finalize=_ppr_finalize,
    local_fixpoint=False, default_supersteps=30)


# ---------------------------------------------------------------------------
# GCN layer — ``out = (D^-1/2 A_w D^-1/2 X) W`` over the plan's content-hash
# edge weights. The loop state is the [K, Vmax, F_in] feature plane; the
# sweep runs gspmm through the ``edge_mul`` hook, and the [F_in, F_out]
# weight matrix applies once at finalize (a plain float32 matmul: the
# reference leaves it outside any kernel too).
# ---------------------------------------------------------------------------

GCN_F_IN = 8
GCN_F_OUT = 4


def _gcn_prepare(plan, kw):
    inv_sqrt = 1.0 / torch.sqrt(_degrees(plan, kw))
    return {"x_local": gather_vertex_channel(plan, _plane(plan, kw["x"])),
            "inv_sqrt_local": torch.where(
                plan.vmask, inv_sqrt[plan.index64("local2global")],
                0.0)[:, :, None],
            "weight": _plane(plan, kw["weight"])}


def _gcn_init(plan, ctx):
    return ctx["x_local"]           # already vmask-pinned to zero rows


def _gcn_pre(state, ctx):
    return state * ctx["inv_sqrt_local"]


def _gcn_edge_mul(plan, ctx):
    return plan.edge_w


def _gcn_apply(old, agg, ctx):
    return agg * ctx["inv_sqrt_local"]


def _gcn_finalize(glob, present, plan, ctx):
    h = torch.where(present[:, None], glob, 0.0)
    return torch.matmul(h, ctx["weight"])


GCN_LAYER = EdgeProgram(
    name="gcn_layer", mode="partial", combine="add",
    prepare=_gcn_prepare, init=_gcn_init, pre=_gcn_pre,
    apply=_gcn_apply, finalize=_gcn_finalize,
    local_fixpoint=False, default_supersteps=1,
    edge_mul=_gcn_edge_mul, state=StateSpec(features=GCN_F_OUT, fill=0.0))


# ---------------------------------------------------------------------------
# KGE triple scoring — DistMult: every live edge e = (u, v) scores
# sum_f ent_u[f]·rel_e[f]·ent_v[f], accumulated onto both endpoints. The
# relation plane is an edge channel in graph slot order; its per-feature
# [K, Emax, F] planes are gspmm's weights. Scalar [V] result.
# ---------------------------------------------------------------------------

KGE_F = 8


def _kge_prepare(plan, kw):
    return {"ent_local": gather_vertex_channel(plan,
                                               _plane(plan, kw["entity"])),
            "rel_local": gather_edge_channel(plan,
                                             _plane(plan, kw["relation"]),
                                             fill=0.0)}


def _kge_init(plan, ctx):
    return ctx["ent_local"]


def _kge_edge_mul(plan, ctx):
    return ctx["rel_local"]


def _kge_apply(old, agg, ctx):
    return ctx["ent_local"] * agg


def _kge_finalize(glob, present, plan, ctx):
    return torch.where(present, glob.sum(dim=1), 0.0)


KGE_SCORE = EdgeProgram(
    name="kge_score", mode="partial", combine="add",
    prepare=_kge_prepare, init=_kge_init, pre=_ident_pre,
    apply=_kge_apply, finalize=_kge_finalize,
    local_fixpoint=False, default_supersteps=1,
    edge_mul=_kge_edge_mul, state=StateSpec(fill=0.0))


# ---------------------------------------------------------------------------
# Convenience entry points
# ---------------------------------------------------------------------------

def engine_sssp(engine: Engine, source: int) -> EngineResult:
    return engine.run(SSSP, source=int(source))


def engine_wcc(engine: Engine) -> EngineResult:
    return engine.run(WCC)


def engine_pagerank(engine: Engine, degrees: torch.Tensor,
                    iters: int = 30) -> EngineResult:
    return engine.run(PAGERANK, max_supersteps=iters, degrees=degrees)


def engine_weighted_sssp(engine: Engine, source: int) -> EngineResult:
    return engine.run(WEIGHTED_SSSP, source=int(source))


def engine_bfs(engine: Engine, source: int) -> EngineResult:
    return engine.run(BFS, source=int(source))


def multi_source_sssp(engine: Engine, sources) -> EngineResult:
    """Batched multi-source distances: one superstep loop answers every
    query; ``result.state`` is [S, V], ``supersteps`` etc. are [S]."""
    return engine.run_batched(
        SSSP, {"source": torch.as_tensor(sources).to(torch.int32)})


def engine_label_propagation(engine: Engine, labels) -> EngineResult:
    """Min-label propagation over an external [V] / [V, 1] label plane."""
    return engine.run(LABELPROP, labels=labels)


def engine_personalized_pagerank(engine: Engine, degrees: torch.Tensor,
                                 personalization,
                                 iters: int = 30) -> EngineResult:
    return engine.run(PPR, max_supersteps=iters, degrees=degrees,
                      personalization=personalization)


def engine_gcn_layer(engine: Engine, degrees: torch.Tensor, x,
                     weight) -> EngineResult:
    """One GCN layer forward pass; ``result.state`` is [V, GCN_F_OUT]."""
    return engine.run(GCN_LAYER, degrees=degrees, x=x, weight=weight)


def engine_kge_score(engine: Engine, entity, relation) -> EngineResult:
    """Per-vertex DistMult triple-score mass; ``result.state`` is [V]."""
    return engine.run(KGE_SCORE, entity=entity, relation=relation)


# ---------------------------------------------------------------------------
# Registry entries — the single declaration each program ever needs. The
# whole serving stack (request validation, batch/cache keys, dispatch,
# tests) derives from these; none of it names a program again.
# ---------------------------------------------------------------------------

def _host(values) -> np.ndarray:
    """An oracle's answer as a host array."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return np.asarray(values)


def _non_negative(v):
    if v < 0:
        raise ValueError(f"iters must be >= 0, got {v}")


registry.register(
    "sssp", SSSP,
    params=[registry.ParamSpec("source", int, batchable=True)],
    oracle=lambda g, source: _host(_alg.reference_sssp(g, source)[0]),
)

registry.register(
    "wcc", WCC,
    oracle=lambda g: _host(_alg.reference_cc(g)[0]),
)

registry.register(
    "pagerank", PAGERANK,
    params=[registry.ParamSpec("iters", int, default=30, role="supersteps",
                               validate=_non_negative)],
    resources={"degrees": lambda g: g.degrees()},
    oracle=lambda g, iters: _host(_alg.reference_pagerank(g, iters=iters)),
    oracle_atol=1e-5,
)

registry.register(
    "wsssp", WEIGHTED_SSSP,
    params=[registry.ParamSpec("source", int, batchable=True)],
    oracle=_alg.reference_weighted_sssp,
)

registry.register(
    "bfs", BFS,
    params=[registry.ParamSpec("source", int, batchable=True)],
    oracle=_alg.reference_bfs,
)

registry.register(
    "labelprop", LABELPROP,
    params=[registry.ParamSpec("labels", float, role="channel",
                               channel="vertex", features=1)],
    oracle=lambda g, labels: _alg.reference_label_propagation(
        g, np.asarray(labels)),
)

registry.register(
    "ppr", PPR,
    params=[registry.ParamSpec("personalization", float, role="channel",
                               channel="vertex", features=1),
            registry.ParamSpec("iters", int, default=30, role="supersteps",
                               validate=_non_negative)],
    resources={"degrees": lambda g: g.degrees()},
    oracle=lambda g, personalization, iters:
        _alg.reference_personalized_pagerank(g, np.asarray(personalization),
                                             iters=iters),
    oracle_atol=1e-5,
)


def _gcn_weight_rows(cv):
    # the dense channel's plan-free shape still has a program contract:
    # rows must match the layer's input width, or the finalize matmul
    # would fail deep inside a dispatch instead of at the server door
    if cv.shape[0] != GCN_F_IN:
        raise ValueError(
            f"gcn_layer.weight is the [F_in, F_out] = "
            f"[{GCN_F_IN}, {GCN_F_OUT}] layer matrix, got {cv.shape}")


registry.register(
    "gcn_layer", GCN_LAYER,
    params=[registry.ParamSpec("x", float, role="channel",
                               channel="vertex", features=GCN_F_IN),
            registry.ParamSpec("weight", float, role="channel",
                               channel="dense", features=GCN_F_OUT,
                               validate=_gcn_weight_rows)],
    resources={"degrees": lambda g: g.degrees()},
    oracle=lambda g, x, weight: _alg.reference_gcn_layer(
        g, np.asarray(x), np.asarray(weight)),
    oracle_atol=1e-5,
)

registry.register(
    "kge_score", KGE_SCORE,
    params=[registry.ParamSpec("entity", float, role="channel",
                               channel="vertex", features=KGE_F),
            registry.ParamSpec("relation", float, role="channel",
                               channel="edge", features=KGE_F)],
    oracle=lambda g, entity, relation: _alg.reference_kge_score(
        g, np.asarray(entity), np.asarray(relation)),
    oracle_atol=1e-5,
)
