# analysis-virtual-path: gserve/instr.py
"""TS001 good: torch calls that read no tensor data (the device's index, a
dtype's range, the process group's rank) are static values, and a tensor's
shape is host metadata."""
import torch

from repro_torch import obs


def after_batch(state):
    rec = obs.get()
    rec.event("serve.batch", device=torch.cuda.current_device(),
              rank=torch.distributed.get_rank(),
              eps=torch.finfo(torch.float32).eps, rows=state.shape[0])
