"""Partition-health gauges derived from a compiled ``PartitionPlan``.

The counterpart of ``repro.obs.health`` over the port's plan, whose
fields are torch tensors (on the card or the CPU): the same gauges with
the same formulas — replication factor Σ|V_i| / |V|, balance (``nstdev``
and ``largest_norm`` of the per-partition edge counts), exchange volume
Σ|F_i| (MESSAGES) and the streaming slack of the CSR and vertex lanes.
It takes the plan as input and imports nothing of the engine, so it stays
a leaf; any object with the plan's fields duck-types.

The result is memoized on the plan instance: plans are immutable (every
change makes a new object), so health is computed at most once per plan,
with one host read of the plan's [K] count vectors.
"""
from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def plan_health(plan) -> dict:
    """Health gauges for one compiled plan (memoized per plan instance)."""
    cached = plan.__dict__.get("_obs_health")
    if cached is not None:
        return cached
    sizes = _host(plan.n_edges_local).astype(np.float64)        # [K]
    total = float(sizes.sum())
    k = int(plan.k)
    mean = total / k if total else 1.0
    norm = sizes / mean
    csr_fill = _host(plan.csr_fill).astype(np.float64)          # [K]
    v_fill = _host(plan.v_fill).astype(np.float64)              # [K]
    health = {
        # the paper's axes
        "replication_factor": float(plan.replication_factor()),
        "balance_nstdev": float(np.sqrt(np.mean((norm - 1.0) ** 2)))
                          if total else 0.0,
        "largest_norm": float(norm.max()) if total else 0.0,
        "exchange_per_superstep": int(plan.exchange_volume),
        # streaming slack: how far each partition is from needing a
        # recompile with larger capacities
        "edge_lane_occupancy_mean": float((csr_fill / plan.e_max).mean()),
        "edge_lane_occupancy_max": float((csr_fill / plan.e_max).max()),
        "vertex_lane_occupancy_mean": float((v_fill / plan.v_max).mean()),
        "vertex_lane_occupancy_max": float((v_fill / plan.v_max).max()),
        "min_free_edge_slots": int((plan.e_max - csr_fill).min()),
        "min_free_vertex_slots": int((plan.v_max - v_fill).min()),
    }
    object.__setattr__(plan, "_obs_health", health)
    return health
