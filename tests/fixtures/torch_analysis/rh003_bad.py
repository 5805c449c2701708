# analysis-virtual-path: engine/registry.py
"""RH003 bad: key function defaults a missing param instead of raising."""


def batch_key_of(prog, params):
    return (prog, params.get("iters", 30))  # FLAG: RH003


def lane_cache_key(prog, epoch, kw):
    return (prog, epoch, kw.get("damping"))  # FLAG: RH003
