# analysis-virtual-path: stream/planes.py
"""AL001 bad: every no-copy passthrough of numpy and torch, on fields the
class mutates with torch's in-place methods and numpy item writes."""
import numpy as np
import torch


class Planes:
    def __init__(self, n):
        self.weights = torch.zeros(n)
        self.counts = torch.zeros(n, dtype=torch.int64)
        self.host = np.zeros(n)
        self.flat = torch.zeros(n)

    def load(self, src, arr, t):
        self.weights = src.detach()  # FLAG: AL001
        self.counts = torch.as_tensor(arr)  # FLAG: AL001
        self.host = t.numpy()  # FLAG: AL001
        self.flat = t.view(-1)  # FLAG: AL001
        self.host = np.asarray(arr)  # FLAG: AL001

    def bump(self, idx, by):
        self.weights.index_add_(0, idx, by)
        self.counts.copy_(self.counts + 1)
        self.flat.fill_(0.0)
        self.host[idx] = 1.0
