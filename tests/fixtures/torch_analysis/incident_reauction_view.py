# analysis-virtual-path: stream/session.py
"""Incident fixture — the ``_reauction`` shared-view bug class.

In the reference ``local_reauction`` returned a jax-backed, read-only
array; assigned straight to ``self.owner``, the next slot-level in-place
write (``self.owner[idx] = p``) raised ``ValueError: assignment
destination is read-only`` — only on the first streamed update after a
re-auction, a path no unit test exercised.  The port's re-auction returns
a host tensor; ``tensor.numpy()`` is a writable view of the same memory,
so the same assignment raises nothing: the session's later slot writes
silently rewrite the tensor the re-auction handed out.  The fix copies
(``np.array(...)``); AL001 must flag the original forever."""


class StreamSession:
    def __init__(self, owner):
        self.owner = list(owner)

    def _reauction(self, g, region):
        new_owner = local_reauction(g, self.owner, region)
        self.owner = new_owner.numpy()  # FLAG: AL001

    def apply_update(self, idx, p):
        self.owner[idx] = p


def local_reauction(g, owner, region):
    raise NotImplementedError  # stand-in for the real kernel-backed call
