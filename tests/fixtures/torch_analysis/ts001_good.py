# analysis-virtual-path: engine/instr.py
"""TS001 good: reductions done on already-synced host values."""
import numpy as np

from repro_torch import obs as _obs


def after_sweep(state_np):
    rec = _obs.get()
    rec.event("engine.sweep", max_state=float(np.max(state_np)))
    _obs.get().gauge("engine.norm", float(np.linalg.norm(state_np)))
