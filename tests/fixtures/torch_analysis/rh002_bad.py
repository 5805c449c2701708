# analysis-virtual-path: engine/dispatch.py
"""RH002 bad: mutable defaults shared across calls / unhashable as static."""


def dispatch(prog, resources={}):  # FLAG: RH002
    return prog, resources


def submit(reqs=[], *, opts=dict()):  # FLAG: RH002  (and the kw-only one)
    return reqs, opts
