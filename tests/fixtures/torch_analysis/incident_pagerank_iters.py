# analysis-virtual-path: engine/registry.py
"""Incident fixture — the pagerank ``iters=None`` cache-identity bug.

A cache key built with ``params.get("iters")`` mapped the
omitted-parameter default and an explicit ``iters=None`` onto the same
compiled program even though validation treated them differently — two
semantically distinct requests shared one cache entry.  Key functions now
index declared params totally (``params[name]`` raises on a miss); RH003
must flag the original forever."""


def cache_key_of(prog, epoch, params):
    return (prog, epoch, params.get("iters"))  # FLAG: RH003
