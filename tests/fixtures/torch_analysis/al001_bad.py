# analysis-virtual-path: stream/owner.py
"""AL001 bad: a view sharing its source's memory assigned to a field the
class mutates in place."""
import torch


class OwnerTable:
    def __init__(self, owner):
        self.owner = torch.tensor(owner)

    def reauction(self, region):
        # a no-copy view of the region's array, on an in-place-mutated field
        self.owner = torch.from_numpy(region.local_reauction())  # FLAG: AL001

    def apply(self, idx, p):
        self.owner[idx] = p
