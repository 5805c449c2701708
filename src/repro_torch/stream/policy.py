"""Compaction policies: when the streaming session compacts + how much
slack it reserves.

Counterpart of ``repro.stream.policy``, over the port's ``obs.Monitor``.

The session's default behaviour is **reactive**: it compacts only when
forced — an insert batch finds the graph out of spare padded slots, or a
partition's reserved slack is exhausted mid-patch (``SlackExhausted``).
Either way the recompile (host compaction, a new plan and its kernel
layouts) lands *inside* the update burst that triggered it, exactly where
latency hurts most.

``CompactionPolicy`` makes that decision pluggable.  The session feeds
the policy its update telemetry (``on_apply``), asks it during idle gaps
whether to compact proactively (``should_compact`` — driven by
``StreamSession.idle_tick()``), and consults it for slack sizing on every
recompile (``recommend_slack``).

``AdaptiveCompactionPolicy`` closes the loop through the observability
layer: it forwards each apply into a ``repro_torch.obs.Monitor``'s stream
telemetry (``observe_update_batch``) and reads back the observed update
rate, slack-burn rate and peak per-batch slack consumption.  From those
it (a) triggers compaction during idle gaps whenever the remaining
graph-slot or partition-slack headroom could not absorb
``headroom_batches`` more bursts of the observed peak magnitude, and
(b) recommends per-partition edge slack sized to the same burst headroom
— so the forced recompile either never happens or is paid in the idle
gap instead of mid-burst.
"""
from __future__ import annotations

import math

from ..obs.health import plan_health
from ..obs.monitor import Monitor


class CompactionPolicy:
    """Base policy = the session's historical reactive behaviour: never
    compact proactively, never override the config's slack sizing."""

    name = "reactive"

    def on_attach(self, session) -> None:
        """Called once when the session binds this policy."""

    def on_apply(self, session, n_updates: int, n_inserted: int,
                 dt_s: float) -> None:
        """Called after every ``apply()`` with the batch's total update
        count, its inserted-edge count (the slack it may have consumed)
        and its wall duration."""

    def on_compact(self, session) -> None:
        """Called after every compaction epoch (forced or idle)."""

    def should_compact(self, session) -> bool:
        """Consulted by ``session.idle_tick()``: compact now, in the idle
        gap, instead of waiting to be forced mid-burst?"""
        return False

    def recommend_slack(self, session) -> tuple[int | None, int | None]:
        """(edge_slack, vertex_slack) recommendation for the next compile;
        ``None`` keeps the session's default sizing for that axis."""
        return None, None


class ReactiveCompactionPolicy(CompactionPolicy):
    """Explicit name for the default: compaction only when forced."""


class AdaptiveCompactionPolicy(CompactionPolicy):
    """Telemetry-driven proactive compaction + slack sizing.

    ``monitor``: the ``repro_torch.obs.Monitor`` to feed/read; omitted,
    the policy owns a private one.  ``headroom_batches``: how many bursts
    of the observed peak magnitude the session must be able to absorb
    without a forced recompile — the knob trading memory (bigger slack)
    against recompiles.
    """

    name = "adaptive"

    def __init__(self, monitor: Monitor | None = None, *,
                 headroom_batches: float = 3.0):
        if headroom_batches <= 0:
            raise ValueError("headroom_batches must be > 0")
        self._owns_monitor = monitor is None
        self.monitor = Monitor() if monitor is None else monitor
        self.headroom_batches = float(headroom_batches)
        self._inserted_since_compact = 0

    def close(self) -> None:
        if self._owns_monitor:
            self.monitor.close()

    # -- telemetry feed ------------------------------------------------------
    def on_apply(self, session, n_updates: int, n_inserted: int,
                 dt_s: float) -> None:
        self.monitor.observe_update_batch(n_updates, n_inserted, dt_s)
        self._inserted_since_compact += int(n_inserted)

    def on_compact(self, session) -> None:
        self._inserted_since_compact = 0

    # -- control -------------------------------------------------------------
    def _headroom_edges(self) -> int:
        """Slot headroom the next bursts need: ``headroom_batches`` times
        the largest single-apply insert burst observed in the window."""
        return int(math.ceil(self.headroom_batches
                             * self.monitor.peak_batch_slack()))

    def should_compact(self, session) -> bool:
        if self._inserted_since_compact <= 0:
            return False          # nothing ingested: compaction buys nothing
        need = self._headroom_edges()
        if need <= 0:
            return False          # no telemetry yet: stay reactive
        free_graph = session.sg.free_slots()
        # partition slack is in CSR half-edge slots; one inserted edge can
        # put both its half-edges in the same partition, hence the 2x
        free_plan = plan_health(session.plan)["min_free_edge_slots"]
        return free_graph < need or free_plan < 2 * need

    def recommend_slack(self, session) -> tuple[int | None, int | None]:
        need = self._headroom_edges()
        return (need, None) if need > 0 else (None, None)
