# analysis-virtual-path: gserve/router.py
"""LP001 good: dispatch through the registry, no string special-casing."""


def route(req, registry):
    spec = registry.lookup(req.kind)   # using .kind as a lookup key is fine
    return spec.dispatch(req)
