# analysis-virtual-path: engine/registry.py
"""RH001 bad: dict iteration order baked into a cache key."""


def cache_key_of(params, resources):
    base = tuple(params.items())  # FLAG: RH001
    res = tuple((resources or {}).keys())  # FLAG: RH001
    return base + res
