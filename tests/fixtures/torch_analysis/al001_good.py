# analysis-virtual-path: stream/owner.py
"""AL001 good: every assignment to a mutated field is provably fresh —
``.clone()``, ``torch.tensor``, torch's allocators, ``np.array``,
``.copy()``, a local assigned fresh, arithmetic."""
import numpy as np
import torch


class OwnerTable:
    def __init__(self, owner):
        self.owner = torch.tensor(owner)
        self.host = np.asarray(owner).copy()
        self.seen = torch.zeros(len(owner), dtype=torch.bool)

    def reauction(self, region):
        new_owner = region.local_reauction()
        self.owner = torch.from_numpy(new_owner).clone()   # a copy
        self.host = np.array(new_owner)                     # a copy
        fresh = torch.zeros_like(self.seen)
        self.seen = fresh[:]

    def shift(self, by):
        self.owner = self.owner + by

    def apply(self, idx, p):
        self.owner[idx] = p
        self.host[idx] = p
        self.seen.fill_(True)
