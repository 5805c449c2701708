# analysis-virtual-path: engine/sweep.py
"""TS002 bad: host syncs inside an autograd Function's forward."""
import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


class _Sweep(torch.autograd.Function):
    """A sweep whose forward reads the device back three times."""
    @staticmethod
    def forward(ctx, state, n):
        host = np.asarray(state)  # FLAG: TS002
        total = float(torch.sum(state))  # FLAG: TS002
        flat = state.tolist()  # FLAG: TS002
        return state * total, host, flat


def driver(state):
    return checkpoint(_inner, state, use_reentrant=False)  # _inner: a root


def _inner(state):
    return state.item()  # FLAG: TS002
