# analysis-virtual-path: engine/converge.py
"""TS003 bad: Python control flow on device values inside a compiled
body."""
import torch


@torch.compile
def converge(state, prev):
    if torch.all(state == prev):  # FLAG: TS003
        return state
    while torch.max(torch.abs(state - prev)) > 1e-6:  # FLAG: TS003
        prev, state = state, state * 0.5
    return state
