# analysis-virtual-path: train/clip.py
"""TS003 bad: an assert, a ternary and a branch that pairs a static
predicate with a device value, in an autograd Function's backward."""
import torch as T


class _Clip(T.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        assert T.isfinite(x).all()  # FLAG: TS003
        return x

    @staticmethod
    def backward(ctx, g):
        g = g if T.linalg.vector_norm(g) < ctx.limit else g * 0.5  # FLAG: TS003
        if T.is_grad_enabled() and T.any(g < 0):  # FLAG: TS003
            g = g.abs()
        return g, None
