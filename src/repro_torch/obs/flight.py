"""Flight recorder: automatic postmortem bundles at the moment of breach.

A copy of ``repro.obs.flight`` (stdlib only, over the port's recorder),
kept in the port so that ``repro_torch`` imports nothing of the JAX
package; its bundles are the reference's, key for key.

A trace exported *after* an incident has usually lost the interesting
part — the ring buffer kept rolling.  ``FlightRecorder`` captures the
whole observable state the instant something goes wrong (an ``obs.alert``
firing, a run crashing, a test failing) into one
self-contained JSON *bundle*:

  * the triggering ``reason`` + alert/context payload,
  * ``Recorder.stats()`` and the full ``obs.snapshot()`` (counters,
    gauges, every provider — the cache hierarchy, serve metrics, monitor
    state; a raising provider degrades to ``{"error": ...}`` instead of
    aborting the dump),
  * the ring buffer contents (every event still in the ring, oldest
    first).

Bundles are **bounded**: at most ``max_bundles`` newest files are kept
per directory (oldest deleted on each dump), so an alert storm cannot
fill a disk.  ``arm(monitor)`` subscribes the dump to a ``Monitor``'s
``on_alert`` hook.

Render a bundle with ``python -m repro_torch.obs.report <bundle.json>``.

Timestamps: bundle *filenames* carry wall-clock UTC (an incident is
looked up by when it happened), via ``datetime`` — the monotonic-only
discipline applies to measured intervals, not to naming.
"""
from __future__ import annotations

import datetime
import itertools
import json
import pathlib
import re
from typing import Callable

from .recorder import Recorder, get

BUNDLE_MARKER = "flight_bundle"        # schema tag + version
BUNDLE_VERSION = 1
_SEQ = itertools.count()


def _slug(text: str, max_len: int = 48) -> str:
    """Filesystem-safe reason slug."""
    s = re.sub(r"[^A-Za-z0-9._-]+", "-", str(text)).strip("-.")
    return s[:max_len] or "dump"


class FlightRecorder:
    """Dumps bounded, timestamped postmortem bundles into one directory."""

    def __init__(self, out_dir: str, *, max_bundles: int = 8,
                 recorder: Recorder | None = None):
        if max_bundles < 1:
            raise ValueError("max_bundles must be >= 1")
        self.out_dir = pathlib.Path(out_dir)
        self.max_bundles = int(max_bundles)
        self._recorder = recorder
        self.n_dumped = 0

    @property
    def recorder(self) -> Recorder:
        return self._recorder if self._recorder is not None else get()

    # -- capture -------------------------------------------------------------
    def dump(self, reason: str, context: dict | None = None) -> pathlib.Path:
        """Capture one bundle now; returns its path.  Never raises on a
        degraded recorder — the postmortem path must work when things are
        already broken."""
        rec = self.recorder
        created = datetime.datetime.now(datetime.timezone.utc)
        seq = next(_SEQ)
        bundle = {
            BUNDLE_MARKER: BUNDLE_VERSION,
            "reason": str(reason),
            "created_utc": created.isoformat(timespec="seconds"),
            "seq": seq,
            "context": context,
            "stats": rec.stats(),
            "snapshot": rec.snapshot(),
            "events": rec.events(),
        }
        self.out_dir.mkdir(parents=True, exist_ok=True)
        name = (f"flight-{created.strftime('%Y%m%dT%H%M%S')}"
                f"-{seq:04d}-{_slug(reason)}.json")
        path = self.out_dir / name
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, sort_keys=True, default=str)
        self.n_dumped += 1
        rec.event("obs.flight_dump", reason=str(reason),
                  bundle=name, seq=seq)
        self._enforce_retention()
        return path

    def _enforce_retention(self) -> None:
        """Keep only the ``max_bundles`` newest bundles (name-sorted: the
        timestamp+seq prefix makes lexical order chronological)."""
        bundles = sorted(self.out_dir.glob("flight-*.json"))
        for old in bundles[:max(0, len(bundles) - self.max_bundles)]:
            try:
                old.unlink()
            except OSError:
                pass

    def bundles(self) -> list[pathlib.Path]:
        """Retained bundles, oldest first."""
        if not self.out_dir.exists():
            return []
        return sorted(self.out_dir.glob("flight-*.json"))

    # -- arming --------------------------------------------------------------
    def arm(self, monitor) -> Callable[[], None]:
        """Dump a bundle whenever ``monitor`` fires an alert (the hook is
        edge-triggered: one bundle per fire transition, retention-bounded).
        Returns a disarm callable."""
        def _on_alert(alert: dict) -> None:
            self.dump(f"alert.{alert.get('kind', 'unknown')}",
                      context=alert)
        monitor.on_alert.append(_on_alert)

        def disarm() -> None:
            if _on_alert in monitor.on_alert:
                monitor.on_alert.remove(_on_alert)
        return disarm

