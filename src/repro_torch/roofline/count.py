"""Count one step's work on any device: the port's counterpart of
``repro/roofline/hlo_parse.py``.

The reference reads FLOPs, bytes and collectives off XLA's compiled HLO.
The port has no compiler: it runs the step once, op by op, under a
``TorchDispatchMode`` (:class:`Counter`) that sees every aten op the step
dispatches, the backward's too. On ``meta`` tensors (the dry run's
stand-ins, ``launch/specs.py``) nothing is computed and nothing is
allocated, so a production-size step is counted on the host; on the card
or the CPU the same code path gives the same counts, which is what
``chip_smoke.py``'s ``dryrun`` phase holds.

The convention is the reference's (``hlo_parse.py:1-40``):

* **FLOPs.** Matrix products 2·M·N·K, from ``torch.utils.flop_counter``'s
  per-op formulas; elementwise arithmetic (ops tagged ``pointwise``, less
  the copies and fills in :data:`MOVEMENT`) one per output element;
  reductions (ops tagged ``reduction``) and scatters (:data:`SCATTERS`)
  one per element of their first tensor operand; everything else zero.
* **Bytes.** The operands plus the outputs of every op that is not a view,
  a reshape or a metadata op (:data:`METADATA`): a no-fusion proxy of
  memory traffic, as the reference's.
* **Peak live bytes.** Every storage an op allocates (one that none of its
  operands holds) is live until it is freed; the peak of their sum over
  the step stands for XLA's ``temp_size_in_bytes`` (the step's arguments
  are allocated before it and never counted).
* **Reads.** The storages that a counted op (or a kernel) takes as an
  operand, views and metadata aside: :meth:`Counter.reads` tells whether
  the step read an argument at all, as ``jax.jit`` drops the arguments a
  step never reads from its compiled program.

The hand-written kernels are opaque: a kernel wrapper runs its body inside
:func:`kernel`, where no op is counted, and adds its ``*_work`` count
(``kernels/ops.py``) as one launch; on ``meta`` the wrapper returns empty
outputs of the card path's shapes and never runs its plain version. Ops on
another device than the counted one (a host-side RNG state) are left out
and tallied apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: Pointwise-tagged ops that move or fill data and compute nothing.
MOVEMENT = frozenset({"clone", "copy", "copy_", "_to_copy", "fill", "fill_",
                      "zero", "zero_", "lift_fresh_copy", "alias_copy",
                      "detach_copy", "_copy_from", "_copy_from_and_resize"})
#: Ops that combine into a destination: one FLOP per destination element.
SCATTERS = frozenset({"index_add", "index_add_", "scatter_add",
                      "scatter_add_", "scatter_reduce", "scatter_reduce_",
                      "index_put", "index_put_", "_index_put_impl_",
                      "cumsum", "cumsum_", "cumprod", "logcumsumexp",
                      "embedding_dense_backward", "index_reduce",
                      "index_reduce_"})
#: Ops that move no bytes: allocation, aliasing and host reads.
METADATA = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "_unsafe_view", "lift_fresh",
                      "detach", "alias", "resize_", "set_", "sym_size",
                      "sym_stride", "sym_numel", "sym_storage_offset",
                      "_local_scalar_dense", "is_same_size", "record_stream"})

_ACTIVE: list["Counter"] = []
_OPAQUE = [0]


@dataclasses.dataclass
class Counts:
    """What one counted step did: FLOPs and bytes (aten ops plus kernel
    launches), the peak of live allocated bytes, and per kernel its
    launches, FLOPs and bytes."""
    flops: int = 0
    bytes: int = 0
    peak_live_bytes: int = 0
    ops: int = 0
    other_device_ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)

    def launches(self) -> dict[str, int]:
        return {k: v["launches"] for k, v in self.kernels.items()}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    """The address of ``t``'s storage: one key for every view of it, and
    never another live storage's (a storage's Python object is made
    afresh when none is alive, so its ``id`` can repeat a dead one's)."""
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose outputs alias an operand without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def op_flops(func, args, kwargs, out) -> int:
    """The FLOPs of one aten op under the convention above."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    name = packet.__name__
    if torch.Tag.pointwise in func.tags and name not in MOVEMENT:
        return sum(t.numel() for t in _tensors(out))
    if torch.Tag.reduction in func.tags or name in SCATTERS:
        first = _tensors((args, kwargs))
        return first[0].numel() if first else 0
    return 0


def op_bytes(func, args, kwargs, out) -> int:
    """Operand plus output bytes of one aten op, 0 for views and metadata."""
    if _is_view(func) or func._overloadpacket.__name__ in METADATA:
        return 0
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


@contextlib.contextmanager
def kernel(name: str, work: tuple[int, int], reads=()):
    """The body of a hand-written kernel's wrapper: no op inside it is
    counted, and on a normal exit each active counter adds one launch of
    ``name`` with ``work`` = (operations, bytes) that read the tensors
    ``reads``."""
    _OPAQUE[0] += 1
    try:
        yield
    finally:
        _OPAQUE[0] -= 1
    for c in _ACTIVE:
        c._launch(name, work, reads)


class Counter(TorchDispatchMode):
    """Counts every aten op dispatched on ``device`` (a device type:
    "meta", "cuda" or "cpu") while it is entered, and the kernel launches
    of :func:`kernel`. ``counts`` holds the tally.

    The list of active counters is global, not per thread: a CUDA
    backward runs on autograd's device thread, and its kernel launches
    must reach the counter the forward entered."""

    def __init__(self, device: str):
        super().__init__()
        self.device = torch.device(device).type
        self.counts = Counts()
        self._live = 0
        self._finalizers: list = []
        self._read: set[int] = set()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()

    def reads(self, t: torch.Tensor) -> bool:
        """Whether the counted step read ``t`` (a tensor that lived through
        the whole step, such as an argument)."""
        return _storage(t) in self._read

    def _launch(self, name: str, work: tuple[int, int], reads) -> None:
        self._read.update(_storage(t) for t in reads)
        flops, nbytes = (int(w) for w in work)
        k = self.counts.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.counts.flops += flops
        self.counts.bytes += nbytes

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def _track(self, ins: list, outs: list) -> None:
        held = {_storage(t) for t in ins}
        for t in outs:
            if _storage(t) in held:
                continue
            held.add(_storage(t))
            st = t.untyped_storage()
            nbytes = st.nbytes()
            self._live += nbytes
            self._finalizers.append(weakref.finalize(st, self._free, nbytes))
        self.counts.peak_live_bytes = max(self.counts.peak_live_bytes,
                                          self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == self.device for t in ins + outs):
            self.counts.other_device_ops += 1
            return out
        self._track(ins, outs)
        if _OPAQUE[0]:
            return out
        self.counts.ops += 1
        self.counts.flops += op_flops(func, args, kwargs, out)
        nbytes = op_bytes(func, args, kwargs, out)
        if nbytes:
            self._read.update(_storage(t) for t in ins)
        self.counts.bytes += nbytes
        return out
