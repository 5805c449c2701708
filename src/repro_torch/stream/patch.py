"""Incremental ``PartitionPlan`` patching.

Counterpart of ``repro.stream.patch``: the same edits give the same plan,
field for field. A compiled plan is a set of static-shape tensors;
recompiling it on every update batch would redo the O(|E|) host
compaction. ``patch_plan`` instead edits a copy of the plan's fields:

  * **deletion** — the edge's two half-edge slots have their ``emask`` bit
    cleared. Masked slots are the combine identity in ``segment_reduce``,
    ``gspmm`` and the exchange, so a cleared slot is inert for min and add
    alike: the CSR prefix keeps its sorted order with holes;
  * **insertion** — two half-edges are appended into the partition's slack
    region ``[csr_fill, e_max-1)``, the lowest free slots first; each
    appended slot is its own segment, which the kernels combine into its
    target after the target's CSR run. Freed slack slots are reused, freed
    *prefix* slots are not (reuse there would break the sorted runs);
  * **vertex arrival/departure** — arriving vertices claim the lowest
    cleared or virgin ``vmask`` slot (its ``last_slot`` is the identity pad
    slot: the vertex's edges live only in slack); vertices whose last local
    edge disappeared have their ``vmask`` bit cleared;
  * the replica-exchange masks (``replicated`` / ``is_master``) and the
    per-partition counts are recomputed exactly.

The port's plan keeps derived values per instance (``index64``,
``run_start``, the exchange volume, the kernels' three layouts), and
``compile_plan_cached`` hands one plan to every caller that shares its
key, so ``patch_plan`` never writes into its input: it returns a new
``PartitionPlan`` at the same shapes (``k``, ``v_max``, ``e_max``,
``epoch``, ``e_slots``) with an empty memo, sharing the input's tensors
for the fields the patch leaves as they were. The new plan has no kernel
layouts yet: whoever installs it builds them (``engine.plan.build_layouts``;
the stream session does so before its engine takes the plan), so the
first query after a patch pays nothing for them. The reference's
per-change loops run here as
numpy over all changes of a partition at once (deletes matched by a sorted
search, inserts given their slots in order), with the same result.

When a partition's slack runs out, ``SlackExhausted`` tells the session to
recompile (a compaction epoch); the input plan is untouched.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..core.graph import edge_weights
from ..engine.plan import PartitionPlan, replica_masks


class SlackExhausted(RuntimeError):
    """A partition ran out of reserved CSR or vertex slack — recompile."""


class EdgeChange(NamedTuple):
    """One edge-level ownership delta. ``old == -1``: pure insert;
    ``new == -1``: pure delete; both >= 0: a re-auction move.

    ``slot`` is the edge's graph slot (StreamingGraph slot id) — the row
    external edge property channels are keyed by. The session always
    provides it; callers constructing raw changes may leave the default
    -1, in which case the patched half-edges read the channel *fill*
    value instead of a feature row (plan.edge_slot stays -1 there).
    """
    u: int
    v: int
    old: int
    new: int
    slot: int = -1


#: Fields a patch may rewrite; the others are shared with the input plan.
_EDGE_FIELDS = ("edge_tgt", "edge_nbr", "seg_start", "edge_w", "edge_slot")
_VERTEX_FIELDS = ("local2global", "last_slot", "v_fill")


def _pair_keys(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Undirected pair keys min * n + max (int64)."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    return np.minimum(a, b) * n + np.maximum(a, b)


def _delete(h: dict, dels: np.ndarray, n: int) -> None:
    """Clear the half-edges of each deleted (u, v, old) in ``h["emask"]``.
    Raises KeyError for an edge its partition does not hold (or one
    deleted twice there), as the reference's per-edge pop does."""
    em, l2g = h["emask"], h["local2global"]
    tgt, nbr = h["edge_tgt"], h["edge_nbr"]
    for p in np.unique(dels[:, 2]).tolist():
        want = _pair_keys(*dels[dels[:, 2] == p, :2].T, n)
        live = np.flatnonzero(em[p])
        have = _pair_keys(l2g[p, tgt[p, live]], l2g[p, nbr[p, live]], n)
        order = np.argsort(have, kind="stable")
        have = have[order]
        lo = np.searchsorted(have, want, "left")
        hi = np.searchsorted(have, want, "right")
        uniq, counts = np.unique(want, return_counts=True)
        bad = (hi == lo) | np.isin(want, uniq[counts > 1])
        if bad.any():
            key = int(want[np.argmax(bad)])
            raise KeyError(f"edge {(key // n, key % n)} not present in "
                           f"partition {p}")
        run = hi - lo
        pos = np.repeat(lo - np.cumsum(run) + run, run) + np.arange(run.sum())
        em[p, live[order[pos]]] = False


def _insert(h: dict, ins: np.ndarray, e_cap: int, n_vertices: int) -> None:
    """Append each inserted (u, v, new, slot) into its partition's slack:
    two half-edges in the lowest free slack slots, new endpoints in the
    lowest free vertex slots, in the order of the changes."""
    for p in np.unique(ins[:, 3]).tolist():
        sel = ins[ins[:, 3] == p]
        m = len(sel)
        fill = int(h["csr_fill"][p])
        fe = np.flatnonzero(~h["emask"][p, fill:e_cap - 1]) + fill
        if len(fe) < 2 * m:
            raise SlackExhausted(f"partition {p}: no CSR slack")
        vm = h["vmask"][p]
        g2l = np.full(n_vertices, -1, np.int64)
        used = np.flatnonzero(vm)
        g2l[h["local2global"][p, used]] = used
        ends = sel[:, :2].reshape(-1)                  # u0, v0, u1, v1, ...
        fresh = ends[g2l[ends] < 0]
        uniq, first = np.unique(fresh, return_index=True)
        arrived = uniq[np.argsort(first)]              # in order of need
        fv = np.flatnonzero(~vm)
        if len(arrived) > len(fv):
            raise SlackExhausted(f"partition {p}: no vertex slack")
        vs = fv[:len(arrived)]
        h["local2global"][p, vs] = arrived
        vm[vs] = True
        h["last_slot"][p, vs] = e_cap - 1   # edges live in slack; the base
        g2l[arrived] = vs                   # aggregate is the identity pad
        if len(vs):
            h["v_fill"][p] = max(int(h["v_fill"][p]), int(vs[-1]) + 1)
        lu, lv = g2l[sel[:, 0]], g2l[sel[:, 1]]
        # same content hash compile_plan uses: patched == recompiled weights
        w = edge_weights(sel[:, 0], sel[:, 1])
        for s, t_, n_ in ((fe[0:2 * m:2], lu, lv), (fe[1:2 * m:2], lv, lu)):
            h["edge_tgt"][p, s] = t_
            h["edge_nbr"][p, s] = n_
            h["emask"][p, s] = True
            h["seg_start"][p, s] = True     # every appended slot: own segment
            h["edge_w"][p, s] = w
            # the inserted edge's graph slot, so external edge channel
            # planes stay aligned: patched == recompiled layout
            h["edge_slot"][p, s] = sel[:, 4]


def patch_plan(plan: PartitionPlan,
               changes: Iterable[EdgeChange]) -> PartitionPlan:
    """Apply edge inserts/deletes/moves to a plan without recompiling;
    returns a new plan without kernel layouts (``plan`` itself when there
    are no changes).

    Raises SlackExhausted (leaving the input plan untouched) when any
    target partition lacks CSR or vertex slack; the caller falls back to
    compile_plan with a bumped epoch.
    """
    changes = [c if isinstance(c, EdgeChange) else EdgeChange(*c)
               for c in changes]
    if not changes:
        return plan
    arr = np.fromiter(itertools.chain.from_iterable(changes), np.int64,
                      5 * len(changes)).reshape(-1, 5)  # u, v, old, new, slot
    dels, ins = arr[arr[:, 2] >= 0], arr[arr[:, 3] >= 0]

    write = ["emask", "vmask", "n_local", "n_edges_local"]
    if len(ins):
        write += [*_EDGE_FIELDS, *_VERTEX_FIELDS]
    h = {name: np.array(plan.host(name)) for name in write}
    h["csr_fill"] = plan.host("csr_fill")
    for name in ("local2global", "edge_tgt", "edge_nbr"):
        h.setdefault(name, plan.host(name))
    if len(dels):
        _delete(h, dels, plan.n_vertices)
    if len(ins):
        _insert(h, ins, plan.e_max, plan.n_vertices)

    # finalise touched partitions: vertex departures + exact counts
    em, vmask, tgt = h["emask"], h["vmask"], h["edge_tgt"]
    for p in np.union1d(dels[:, 2], ins[:, 3]).tolist():
        deg = np.bincount(tgt[p, em[p]], minlength=plan.v_max)
        vmask[p] &= deg > 0
        h["n_local"][p] = int(vmask[p].sum())
        h["n_edges_local"][p] = int(em[p].sum()) // 2
    replicated, is_master = replica_masks(h["local2global"], vmask,
                                          plan.n_vertices, plan.k)
    h.update(replicated=replicated, is_master=is_master,
             n_replicated=replicated.sum(1).astype(np.int32))
    write += ["replicated", "is_master", "n_replicated"]

    fields = {}
    for name in write:
        a = h[name]
        fields[name] = torch.from_numpy(a).to(plan.device)
        a.flags.writeable = False
    new = dataclasses.replace(plan, **fields)
    for name in write:       # the host copies this patch made are the new
        new._memo(f"_host_{name}", lambda a=h[name]: a)   # plan's own
    return new
