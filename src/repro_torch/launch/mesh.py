"""Production meshes and the card's peaks (the counterpart of
``repro/launch/mesh.py``).

The meshes keep the reference's shapes and axis names. They are the
port's own ``sharding.Mesh`` objects, named axis sizes with no devices, so
building one touches no device state.

The peaks are the published figures of the NVIDIA H100 SXM5 80GB (the
card's data sheet) at its 700 W power limit; a card held below that
limit runs slower under load. The dry run's roofline
(``roofline/analysis.py``) divides by them, the kernels' bounds in
``chip_smoke.py`` and the cost model's utilization (``obs/profile.py``)
too.
"""
from __future__ import annotations

from ..sharding.env import Mesh

#: The card the peaks are for, and the power limit they hold at.
CARD = "NVIDIA H100 SXM5 80GB"
POWER_LIMIT_W = 700
#: Dense bfloat16 tensor-core FLOP/s (the data sheet's 1,979 TFLOP/s is
#: with 2:4 sparsity; dense is half).
PEAK_FLOPS_BF16 = 989.5e12
#: float32 FLOP/s on the CUDA cores (no tensor cores).
FP32_FLOPS = 67e12
#: HBM3 bytes/s.
HBM_BW = 3.35e12
#: NVLink bytes/s of one GPU in one direction: the data sheet's 900 GB/s
#: is both directions summed over its 18 links.
LINK_BW = 450e9


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    return Mesh(tuple(shape), tuple(axes))


def parse_mesh(s: str) -> Mesh:
    """``"1x1"``, ``"DxM"`` or ``"PxDxM"`` as a mesh with the reference
    launcher's axis names (``src/repro/launch/train.py::parse_mesh``):
    ("data",), ("data", "model") or ("pod", "data", "model")."""
    dims = tuple(int(x) for x in s.split("x"))
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}.get(len(dims))
    if axes is None or min(dims) < 1:
        raise ValueError(f"--mesh {s!r}: expected 1, 2 or 3 sizes "
                         "joined by 'x', e.g. 2x4")
    return Mesh(dims, axes)
