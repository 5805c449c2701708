"""repro_torch — the PyTorch/CUDA port of ``repro``.

Graph → DFEP edge partitioning → compacted per-partition CSR plan → engine
supersteps (SSSP, WCC, PageRank and the GNN programs), streaming
maintenance of the partition and the plan (``stream``) with graph-query
serving over it (``gserve``), and the paper's own
dense ETSCH framework with its partition metrics and baselines, with
hand-written CUDA kernels (``csrc/``) for the segmented reduce, the replica
update, gSpMM, the min-plus sweep, the frontier min and DFEP's rank
cumsum; and language-model serving (``configs``, ``models``, ``serve``,
``launch``, with ``data``'s synthetic inputs: prefill and greedy decode
of every family of the JAX package, Mamba's layers through a
hand-written selective-scan kernel). It imports ``torch`` and numpy and
nothing of the JAX package.
Entry points run on the card unless the caller passes ``device="cpu"``.
The multi-device path (sharded DFEP and ETSCH, ``Engine(plan, group=...)``)
runs one rank of a ``torch.distributed`` process group per device.

``core``, ``engine`` and ``kernels`` load on first use (PEP 562), so
``import repro_torch.analysis`` — the stdlib-only static checker — loads
neither torch nor numpy.
"""
import importlib

_LAZY = ("core", "engine", "kernels")


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
