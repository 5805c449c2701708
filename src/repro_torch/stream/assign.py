"""Online greedy assignment of arriving edges — HDRF-style heuristic.

A copy of ``repro.stream.assign`` (host numpy only), kept in the port so
that ``repro_torch`` imports nothing of the JAX package: for the same
stream it places every edge in the same partition.

New edges cannot wait for a full DFEP auction, so they are placed by the
streaming rule of Petroni et al.'s HDRF (the high-degree-replicated-first
scoring used by the streaming partitioners in PAPERS.md), *seeded from the
current DFEP owner state*: partition presence sets and sizes are initialised
from the edges DFEP already assigned, so arriving edges are attracted to the
partitions that already hold their endpoints and the DFEP territories grow
contiguously instead of being diluted by hash placement.

Score for edge (u, v) and partition p:

    C_rep(p) = g(u, p) + g(v, p),  g(x, p) = 1 + (1 - theta_x) if x ∈ A(p)
    C_bal(p) = lam * (maxsize - size_p) / (eps + maxsize - minsize)
    place at argmax C_rep + C_bal

where theta_x = d(x) / (d(u) + d(v)) uses the *partial* degrees seen so far,
so the lower-degree endpoint dominates the replica-affinity term (replicate
the high-degree vertex, keep the low-degree one intact — the HDRF insight
that bounds replication on power-law graphs).

The loop is sequential by construction (each placement updates the presence
sets the next decision reads); chunks are small and host-side numpy is the
honest cost model here, matching the greedy baseline in ``core/baselines.py``.
"""
from __future__ import annotations

import numpy as np


def seed_state(u: np.ndarray, v: np.ndarray, owner: np.ndarray, n_vertices: int,
               k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(presence [V, K], sizes [K], degrees [V]) from a live edge list with
    its current DFEP assignment (owner >= 0 for every live edge)."""
    presence = np.zeros((n_vertices, k), bool)
    presence[u, owner] = True
    presence[v, owner] = True
    sizes = np.bincount(owner, minlength=k).astype(np.int64)
    degrees = (np.bincount(u, minlength=n_vertices)
               + np.bincount(v, minlength=n_vertices)).astype(np.int64)
    return presence, sizes, degrees


def hdrf_assign(edges_u: np.ndarray, edges_v: np.ndarray,
                presence: np.ndarray, sizes: np.ndarray,
                degrees: np.ndarray, lam: float = 1.1,
                eps: float = 1.0) -> np.ndarray:
    """Assign each (u, v) in order; ``presence``/``sizes``/``degrees`` are
    updated in place so a session carries one state across chunks."""
    k = sizes.shape[0]
    out = np.empty(len(edges_u), np.int32)
    for m, (a, b) in enumerate(zip(edges_u.tolist(), edges_v.tolist())):
        degrees[a] += 1
        degrees[b] += 1
        theta_a = degrees[a] / (degrees[a] + degrees[b])
        c_rep = (presence[a] * (2.0 - theta_a)          # 1 + (1 - theta_a)
                 + presence[b] * (1.0 + theta_a))       # 1 + (1 - theta_b)
        mx = sizes.max()
        c_bal = lam * (mx - sizes) / (eps + mx - sizes.min())
        p = int(np.argmax(c_rep + c_bal))
        out[m] = p
        presence[a, p] = presence[b, p] = True
        sizes[p] += 1
    return out
