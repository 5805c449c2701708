# analysis-virtual-path: models/trace_roots.py
"""TS002 bad: every kind of trace root the port has or may grow — a
backward (``from torch.autograd import Function``), a closure handed to an
aliased checkpoint, ``torch.compile`` (bare and called), ``torch.jit.script``,
``torch.func.vmap``, ``make_graphed_callables`` and a ``torch.cuda.graph``
capture — and the functions they reach by bare name, nested ones included."""
import numpy as np
import torch
import torch.utils.checkpoint as cp
from torch.autograd import Function
from torch.func import vmap


class _Scale(Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        torch.cuda.synchronize()  # FLAG: TS002
        return _helper(g)


def _helper(g):
    return g.cpu()  # FLAG: TS002


def run_blocks(x, blocks):
    def pinned(b, h):
        return h * b.numpy()  # FLAG: TS002
    for b in blocks:
        x = cp.checkpoint(pinned, b, x, use_reentrant=False)
    return x


@torch.compile
def fused(x):
    return x * int(torch.count_nonzero(x))  # FLAG: TS002


@torch.compile(mode="max-autotune")
def fused_again(x):
    def inner(y):
        return np.array(y)  # FLAG: TS002
    return inner(x)


@torch.jit.script
def scripted(x):
    return x.item()  # FLAG: TS002


def _lane(x):
    return bool(torch.isnan(x).any())  # FLAG: TS002


def per_lane(xs):
    return vmap(_lane)(xs)


def _graphed_step(x):
    return x.tolist()  # FLAG: TS002


def graphed(x):
    return torch.cuda.make_graphed_callables(_graphed_step, (x,))


def capture(x, g):
    with torch.cuda.graph(g):
        y = x * 2
        n = y.sum().item()  # FLAG: TS002
    return y, n
