# analysis-virtual-path: gserve/router.py
"""LP001 bad: per-kind string branching in the serving layer — including
the reversed-operand form the old grep guard could not see."""


def route(req):
    if req.kind == "sssp":  # FLAG: LP001
        return "shortest"
    if "pagerank" == req.kind:  # FLAG: LP001
        return "rank"
    if req.channel != "vertex":  # FLAG: LP001
        return "edgeplane"
    return "generic"
