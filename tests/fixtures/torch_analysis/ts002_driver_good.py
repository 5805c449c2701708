# analysis-virtual-path: engine/loop.py
"""TS002 good: the superstep loop is a host driver — it reads one flag a
sweep (``bool((ns != st).any())``, ``int(steps.max())``) between its
launches, and the functions it calls are not trace roots.  The autograd
Function it may call stays free of syncs."""
import torch


class _Relax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, w):
        return torch.minimum(st, st @ w)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sweep(st, w):
    return _Relax.apply(st, w)


def run_loop(st, w, cap):
    changed, it = True, 0
    while changed and it < cap:
        ns = _sweep(st, w)
        changed = bool((ns != st).any())
        st, it = ns, it + 1
    steps = torch.as_tensor(it)
    return st, int(steps.max())
