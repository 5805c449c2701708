# analysis-virtual-path: engine/registry.py
"""RH003 good: key functions index declared params totally (KeyError on
a missing param beats silently aliasing two requests onto one cache
entry)."""


def batch_key_of(prog, params):
    return (prog, params["iters"])


def admit(params):
    # .get() outside *key*-named functions is unrestricted
    return params.get("priority", 0)
