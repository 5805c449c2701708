"""repro_torch.obs — tracing, partition-health telemetry and cost
attribution (PyTorch port).

The counterpart of ``repro.obs``, with the same names: a process-global
``Recorder`` (fixed-size ring buffer of structured events and spans, a
no-op when disabled) that the engine, the registry and the server record
into; ``plan_health``, the partition-health gauges of a compiled plan;
exporters to JSONL and Chrome trace-event format (``export_jsonl``,
``export_chrome_trace``) so a served request can be followed from
admission to host materialisation in Perfetto; the mergeable
log-bucketed histograms (``LogHistogram`` / ``WindowedHistogram``) behind
the serving metrics; the SLO burn-rate ``Monitor`` (with ``SLOPolicy`` and
``GaugeWatch``) and a ``FlightRecorder`` that dumps bounded postmortem
bundles the instant an alert fires (render with ``python -m
repro_torch.obs.report``); and the cost-attribution layer: per-sweep
``CostModel``s counted from the plan (``obs.profile``) joined with each
served batch's measured device time into a mergeable per-tenant
``CostLedger`` (``obs.ledger``, render with ``python -m
repro_torch.obs.usage``) that prices cost-aware admission in
``repro_torch.gserve``.  Bundles, traces and ledger dumps have the
reference's schema: either package's renderers read the other's.

Typical use::

    from repro_torch import obs
    obs.enable()
    ... serve queries ...
    print(obs.snapshot())                  # live stats of every provider
    obs.export_chrome_trace("trace.json")  # open in ui.perfetto.dev
"""
from .export import export_chrome_trace, export_jsonl
from .flight import FlightRecorder
from .health import plan_health
from .histogram import LogHistogram, WindowedHistogram
from .ledger import CostLedger, CostSample, get_ledger
from .monitor import GaugeWatch, Monitor, SLOPolicy
from .profile import CostModel, cost_model
from .recorder import Recorder, get

__all__ = [
    "CostLedger", "CostModel", "CostSample", "FlightRecorder",
    "GaugeWatch", "LogHistogram", "Monitor", "Recorder", "SLOPolicy",
    "WindowedHistogram", "cost_model", "disable", "enable", "event",
    "export_chrome_trace", "export_jsonl", "get", "get_ledger",
    "plan_health", "reset", "snapshot",
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
