# analysis-virtual-path: core/fixed_point.py
"""TS002/TS003 bad: the port's convergence idiom — ``bool((a != b).any())``
— inside a checkpointed body, where every recompute would stall on it."""
import torch
from torch.utils.checkpoint import checkpoint


def _sweep(st, w):
    new = torch.minimum(st, st @ w)
    changed = bool((new != st).any())  # FLAG: TS002
    if (new - st).abs().max() > 0:  # FLAG: TS003
        st = new
    return st, changed


def fixed_point(st, w):
    return checkpoint(_sweep, st, w, use_reentrant=False)
