"""Epoch-keyed result cache for the serving layer.

A copy of ``repro.gserve.cache`` (numpy only).

Results depend only on the *graph content* (and the query parameters), not
on how the graph is partitioned — so entries are keyed by
``(Graph.fingerprint(), request.cache_key())``.  The fingerprint is the
engine plan cache's content key too (engine/plan.py), which makes the
invalidation story exact rather than heuristic:

  * every installed plan change (stream patch or compaction recompile)
    changes the edge set, hence the fingerprint, hence every key — the
    server additionally calls ``invalidate_except(new_fingerprint)`` on its
    epoch-change hook so stale entries are *dropped* (not merely
    unreachable) the moment the buffer swaps;
  * a graph that mutates and mutates back to identical content legally
    re-hits old entries (content addressing, same rationale as
    ``compile_plan_cached``).

LRU-bounded; all hit/miss/invalidation counts feed ``gserve.metrics``.
"""
from __future__ import annotations

import collections

import numpy as np


class ResultCache:
    def __init__(self, max_entries: int = 512):
        self.max_entries = int(max_entries)
        self._d: "collections.OrderedDict[tuple, np.ndarray]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, fingerprint: str, key: tuple) -> np.ndarray | None:
        full = (fingerprint, key)
        val = self._d.get(full)
        if val is None:
            self.misses += 1
            return None
        self.hits += 1
        self._d.move_to_end(full)
        return val

    def put(self, fingerprint: str, key: tuple, value: np.ndarray) -> None:
        self._d[(fingerprint, key)] = value
        self._d.move_to_end((fingerprint, key))
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def invalidate_except(self, fingerprint: str) -> int:
        """Drop every entry not keyed by ``fingerprint``; returns the count.
        Called from the server's epoch-change hook on every buffer swap."""
        stale = [k for k in self._d if k[0] != fingerprint]
        for k in stale:
            del self._d[k]
        self.invalidated += len(stale)
        return len(stale)

    def fingerprints(self) -> set[str]:
        return {k[0] for k in self._d}

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "invalidated": self.invalidated, "evictions": self.evictions,
                "size": len(self._d), "max_entries": self.max_entries}
