# analysis-virtual-path: engine/registry.py
"""RH001 good: keys sorted before they become cache identity."""


def cache_key_of(params, resources):
    base = tuple(sorted(params.items()))
    res = tuple(sorted((resources or {}).keys()))
    return base + res
