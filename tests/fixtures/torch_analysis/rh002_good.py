# analysis-virtual-path: engine/dispatch.py
"""RH002 good: None defaults, constructed inside."""


def dispatch(prog, resources=None):
    return prog, dict(resources or {})


def submit(reqs=None, *, opts=None):
    return list(reqs or ()), dict(opts or {})
