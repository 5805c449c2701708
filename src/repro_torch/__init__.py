"""repro_torch — the PyTorch/CUDA port of ``repro``.

Graph → DFEP edge partitioning → compacted per-partition CSR plan → ETSCH
supersteps (SSSP, WCC, PageRank), with hand-written CUDA kernels for the
per-target segmented reduce and the replica update (``csrc/``). It imports
``torch`` and numpy and nothing of the JAX package. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from . import core, engine  # noqa: F401
