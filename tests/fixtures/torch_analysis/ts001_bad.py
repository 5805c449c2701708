# analysis-virtual-path: engine/instr.py
"""TS001 bad: torch reductions computed inside recorder event arguments."""
import torch

from repro_torch import obs as _obs


def after_sweep(state):
    rec = _obs.get()
    rec.event("engine.sweep", max_state=float(torch.amax(state)))  # FLAG: TS001
    _obs.get().gauge("engine.norm", torch.linalg.norm(state))  # FLAG: TS001
