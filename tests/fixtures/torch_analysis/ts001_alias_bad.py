# analysis-virtual-path: gserve/instr.py
"""TS001 bad, the aliased forms: ``import torch as T``, ``from torch import
amax``, torch.nn.functional under its own alias, and a method chain whose
base is a torch call.  TS001 applies in every subsystem."""
import torch as T
import torch.nn.functional as F
from torch import amax

from repro_torch import obs


def after_batch(rec_state, logits):
    rec = obs.get()
    rec.event("serve.batch", top=int(amax(rec_state)))  # FLAG: TS001
    rec.gauge("serve.norm", T.linalg.vector_norm(rec_state))  # FLAG: TS001
    rec.counter("serve.tokens", F.softmax(logits, -1).argmax().item())  # FLAG: TS001
    rec.event("serve.zeros", n=T.zeros(3).sum().item())  # FLAG: TS001
