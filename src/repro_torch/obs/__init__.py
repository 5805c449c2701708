"""repro_torch.obs — tracing and partition-health telemetry (PyTorch port).

The part of ``repro.obs`` the serving path needs: a process-global
``Recorder`` (fixed-size ring buffer of structured events and spans, a
no-op when disabled) that the engine, the registry and the server record
into; the mergeable log-bucketed histograms (``LogHistogram`` /
``WindowedHistogram``) behind the serving metrics; and ``plan_health``,
the partition-health gauges of a compiled plan. The exporters, the SLO
monitor, the flight recorder, the cost model and ledger and the reports
of the reference are not ported yet.

Typical use::

    from repro_torch import obs
    obs.enable()
    ... serve queries ...
    print(obs.snapshot())                  # live stats of every provider
"""
from .health import plan_health
from .histogram import LogHistogram, WindowedHistogram
from .recorder import Recorder, get

__all__ = [
    "LogHistogram", "Recorder", "WindowedHistogram", "disable", "enable",
    "event", "get", "plan_health", "reset", "snapshot",
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
