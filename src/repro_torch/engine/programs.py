"""Graph programs expressed against the engine API (PyTorch), the
counterparts of ``repro.engine.programs``:

  * SSSP       — unit-weight shortest paths (paper Algorithm 1),
  * WCC        — connected components via min-label epidemic (Algorithm 2;
                 labels are vertex ids),
  * PageRank   — partial in-flow sums per partition, completed across the
                 cut each superstep (§III sketch).

Programs are module-level constants; per-query values (source vertex,
degree vector) travel in the ``ctx`` dict.
"""
from __future__ import annotations

import torch

from .runtime import EdgeProgram, Engine, EngineResult

INF = float("inf")
DAMPING = 0.85


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------

def _sssp_prepare(plan, kw):
    return {"source": int(kw["source"])}


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

def _pr_prepare(plan, kw):
    deg = torch.as_tensor(kw["degrees"], device=plan.device)
    deg = deg.to(torch.float32).clamp(min=1.0)
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
# Convenience entry points
# ---------------------------------------------------------------------------

def engine_sssp(engine: Engine, source: int) -> EngineResult:
    return engine.run(SSSP, source=int(source))


def engine_wcc(engine: Engine) -> EngineResult:
    return engine.run(WCC)


def engine_pagerank(engine: Engine, degrees: torch.Tensor,
                    iters: int = 30) -> EngineResult:
    return engine.run(PAGERANK, max_supersteps=iters, degrees=degrees)
