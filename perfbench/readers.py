"""Arithmetic the metric readers (``metrics/<name>.py``) share."""
from __future__ import annotations

from . import bounds


def serving(run) -> bool:
    return run.traffic["driver"] == "closed_loop"


def partitioning(run) -> bool:
    return run.traffic["driver"] == "partitions"


def idle_share(run) -> float | None:
    """% of the traced window in which no operation ran on the device."""
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def lanes_roofline(run, launch_key: str, kernel: str, work) -> float | None:
    """% of its roofline a lane kernel reached over the traced micro-batches:
    the least time of every launch, at its batch's lane width and the
    plan's counts (``bounds``), over the kernels' device time. None where
    the trace does not hold exactly the launches the program counted."""
    if run.profile is None or "plan" not in run.sizes:
        return None
    n_traced, seconds = run.profile.kernel(kernel)
    launched = sum(n.get(launch_key, 0) for _, n in run.launches)
    if seconds <= 0 or launched == 0 or n_traced != launched:
        return None
    least = sum(n.get(launch_key, 0)
                * bounds.least_seconds(work(run.sizes["plan"], width))
                for width, n in run.launches)
    return 100.0 * least / seconds
