"""repro_torch.obs — tracing and partition-health telemetry (PyTorch port).

The part of ``repro.obs`` the serving path needs: a process-global
``Recorder`` (fixed-size ring buffer of structured events and spans, a
no-op when disabled) that the engine, the registry and the server record
into; the mergeable log-bucketed histograms (``LogHistogram`` /
``WindowedHistogram``) behind the serving metrics; ``plan_health``, the
partition-health gauges of a compiled plan; and the SLO burn-rate
``Monitor`` (with ``SLOPolicy`` and ``GaugeWatch``) that the server feeds
and the streaming session's adaptive compaction policy reads. The
exporters, the flight recorder, the cost model and ledger and the reports
of the reference are not ported yet.

Typical use::

    from repro_torch import obs
    obs.enable()
    ... serve queries ...
    print(obs.snapshot())                  # live stats of every provider
"""
from .health import plan_health
from .histogram import LogHistogram, WindowedHistogram
from .monitor import GaugeWatch, Monitor, SLOPolicy
from .recorder import Recorder, get

__all__ = [
    "GaugeWatch", "LogHistogram", "Monitor", "Recorder", "SLOPolicy",
    "WindowedHistogram", "disable", "enable", "event", "get", "plan_health",
    "reset", "snapshot",
]


def enable(capacity: int | None = None) -> None:
    get().enable(capacity)


def disable() -> None:
    get().disable()


def reset() -> None:
    get().reset()


def event(name: str, **args) -> None:
    get().event(name, **args)


def snapshot() -> dict:
    return get().snapshot()
