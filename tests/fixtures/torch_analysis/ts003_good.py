# analysis-virtual-path: kernels/ops.py
"""TS003 good: branches on Python values inside trace roots.  Predicates
that read no tensor data — ``torch.is_grad_enabled()`` (the scan's
autograd switch), ``torch.is_tensor``, ``torch.cuda.is_available()``,
``torch.distributed.is_initialized()``, ``torch.jit.is_scripting()`` — a
dtype or shape comparison, and ``is None`` tests are static branches."""
import torch


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0=None):
        args = (x,) if h0 is None else (x, h0)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            ctx.keep = True
        if torch.is_tensor(h0) and h0.dtype == torch.float32:
            x = x + h0.sum(-1)
        if torch.cuda.is_available() and x.is_cuda:
            x = x * 1.0
        return x if x.ndim == 3 else x[None]

    @staticmethod
    def backward(ctx, g):
        if torch.distributed.is_initialized() and not torch.jit.is_scripting():
            g = g * 1.0
        while g.ndim > 3:
            g = g.sum(0)
        assert g.shape[-1] > 0
        return g, None
