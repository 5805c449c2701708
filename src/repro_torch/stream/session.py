"""StreamSession — the streaming subsystem's front door.

Counterpart of ``repro.stream.session`` on one device. Owns the full
pipeline state: a ``StreamingGraph`` (chunked slot-level ingest), the
slot-parallel DFEP ``owner`` array, the slack-compiled ``PartitionPlan``,
and the ``Engine`` bound to it. One ``apply()`` call takes a batch of
insertions + deletions and leaves the session queryable again:

  1. updates are ingested chunk by chunk (``chunk_size`` fixed);
  2. arriving edges are placed online by the HDRF rule seeded from the
     current owner state (assign.py);
  3. the plan is *patched* (patch.py): a new plan at the same shapes, its
     kernel layouts built on the card before it is installed;
  4. if the replication factor has drifted past ``drift_threshold`` above
     its post-correction baseline, a bounded local re-auction
     (reauction.py) re-sells the h-hop region around touched vertices on
     the device and the resulting moves are patched in too;
  5. only two events recompile: a partition exhausting its reserved slack,
     or the graph itself running out of spare padded slots (a compaction
     epoch — ``epoch`` bumps).

Every installed plan (patch, re-auction patch, recompile) reaches the
engine through ``Engine.with_plan``. The reference's "a patch never
retraces" invariant becomes: a patch allocates no plan-shaped tensor
beyond the new plan's own fields and layouts, and the next query launches
the same kernels at the same shapes. The reference's ``engine.retrace``
event has no counterpart: the port's loops are eager and trace nothing.
With the recorder on, a patch records two spans of its own inside
``stream.apply``: ``stream.patch_plan`` (the new plan's fields, host
side) and ``stream.layouts`` (its kernel layouts, on the card only).

A pluggable ``CompactionPolicy`` (policy.py) decides *when* beyond the
forced cases: ``idle_tick()`` lets the policy compact proactively during
idle gaps, and ``recommend_slack`` lets it size the reserved slack from
observed update telemetry on every recompile.

Where the reference partitions with a JAX key when no ``owner`` is given,
the port takes DFEP's ``starts`` (or draws them from ``seed``), as
``core.dfep.partition`` does. The session runs on ``device`` (default
``cuda``; pass ``"cpu"`` for the plain PyTorch path).

Engine results over the session plan stay exactly consistent with the
whole-graph oracles on ``session.graph()`` (tests/test_torch_stream.py).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable

import numpy as np

import torch

from .. import obs as _obs
from ..core import dfep
from ..core.graph import resolve_device
from ..engine import registry as _registry
from ..engine.plan import build_layouts, compile_plan
from ..engine.runtime import Engine
from . import assign, reauction
from .ingest import StreamingGraph, iter_chunks
from .patch import EdgeChange, SlackExhausted, patch_plan
from .policy import CompactionPolicy, ReactiveCompactionPolicy


@dataclasses.dataclass
class _BoundChannel:
    """One session-maintained property plane (see bind_channel)."""
    program: str
    param: str
    channel: str                      # "vertex" | "edge"
    features: int
    values: np.ndarray                # working copy, [V,F] or [e_pad,F]
    fill: Callable | None             # (u, v) -> feature row for inserts


# registry bindings are process-global (they resolve at QueryRequest
# construction), so two sessions maintaining the same (program, param)
# would silently clobber each other's planes. This ownership map turns
# that into a loud error: a session may only (re)bind a slot that is
# free, or that it already owns. A weakref.finalize per bind releases
# BOTH the slot and the registry binding when a session is dropped
# without unbind_channel — a garbage-collected maintainer must not leave
# its last (now unmaintained) plane silently live for normalize().
_BINDING_OWNERS: dict[tuple[str, str], "weakref.ref"] = {}


def _release_binding(key: tuple[str, str], ref, entry) -> None:
    """Session finalizer: drop the ownership slot and the registry binding
    iff they still belong to the dead session (identity-checked via the
    exact ref object — a successor's rebind installs a different ref and
    must survive this)."""
    if _BINDING_OWNERS.get(key) is ref:
        _BINDING_OWNERS.pop(key, None)
        entry.unbind_channel(key[1])


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    k: int
    chunk_size: int = 256
    edge_slack: int | None = None     # per-partition undirected-edge slack
    vertex_slack: int | None = None   # per-partition local-vertex slack
    drift_threshold: float = 0.10     # RF drift triggering local re-auction
    hops: int = 2                     # re-auction region radius
    reauction_max_rounds: int = 400
    compaction_headroom: float = 0.5
    hdrf_lambda: float = 1.1


class StreamSession:
    """Live-graph serving session: ingest updates, keep the partition and
    the compiled plan maintained, answer engine queries in between."""

    def __init__(self, g, cfg: StreamConfig, seed: int = 0,
                 owner=None, policy: CompactionPolicy | None = None, *,
                 starts=None, device=None):
        self.cfg = cfg
        self.k = cfg.k
        self.device = resolve_device(device)
        if g.device != self.device:
            g = g.to(self.device)
        self.policy = policy if policy is not None \
            else ReactiveCompactionPolicy()
        self.sg = StreamingGraph(g, chunk_size=cfg.chunk_size)
        if owner is None:
            owner, _ = dfep.partition(g, k=cfg.k, starts=starts, seed=seed,
                                      device=self.device)
        if isinstance(owner, torch.Tensor):
            owner = owner.cpu().numpy()
        self.owner = np.array(owner, np.int32)         # [e_pad], -2 at pads
        self.touched = np.zeros(g.n_vertices, bool)
        self.epoch = 0
        self.n_ingested = 0
        self.n_patches = 0
        self.n_recompiles = 0
        self.n_forced_recompiles = 0   # recompiles paid mid-apply (slack or
                                       #   slot exhaustion) — what the
                                       #   adaptive policy tries to avoid
        self.n_idle_compactions = 0    # proactive compactions via idle_tick
        self.n_reauctions = 0
        # monotone plan-version token: bumps on EVERY installed plan (patch,
        # re-auction patch, or compaction recompile) — the serving layer's
        # epoch-change signal. ``epoch`` only tracks compactions.
        self.version = 0
        # what the most recent installed plan changed about the graph
        # *content* — the serving layer's warm-start lineage signal:
        # "insert_only" / "none" hops keep previous-epoch results valid as
        # relaxation upper bounds, "mixed" (any deletion) breaks the chain.
        self.last_change: dict = {"event": "init", "content_delta": "none",
                                  "inserts": 0, "deletes": 0, "moves": 0}
        self._subscribers: list[Callable[["StreamSession", str], None]] = []
        self._channels: dict[tuple[str, str], _BoundChannel] = {}
        self.engine: Engine | None = None
        self.policy.on_attach(self)
        self._compile()
        self.rf_base = self.plan.replication_factor()

    # -- epoch-change hooks (the serving layer subscribes) -------------------
    def subscribe(self, fn: Callable[["StreamSession", str], None]):
        """Register ``fn(session, event)`` to run after every installed plan
        change, with ``event`` in {"patch", "recompile"}. By the time the
        hook fires, ``self.plan`` / ``self.engine`` / ``self.version`` are
        the NEW state; the previous plan object is untouched (a patch
        makes a new plan), so in-flight consumers of it keep draining
        against a consistent snapshot. Returns an unsubscribe callable."""
        self._subscribers.append(fn)

        def unsubscribe() -> None:
            if fn in self._subscribers:
                self._subscribers.remove(fn)
        return unsubscribe

    def _notify(self, event: str) -> None:
        self.version += 1
        rec = _obs.get()
        if rec.enabled:
            # stamp every installed plan mutation with the paper's health
            # gauges (replication factor, balance, slack remaining) — the
            # numbers the partitioning is judged on, live instead of
            # post-hoc; plan_health is memoized per plan instance
            health = _obs.plan_health(self.plan)
            rec.event("stream.plan_swap", event=event,
                      version=self.version, epoch=self.epoch,
                      content_delta=self.last_change.get("content_delta"),
                      inserts=self.last_change.get("inserts", 0),
                      deletes=self.last_change.get("deletes", 0),
                      moves=self.last_change.get("moves", 0), **health)
            for name, value in health.items():
                rec.gauge(f"stream.{name}", value)
        for fn in list(self._subscribers):
            fn(self, event)

    # -- plan lifecycle -----------------------------------------------------
    def _slack(self) -> tuple[int, int]:
        """Default slack is sized from the update granularity (a few chunks
        per partition) with a small |E|-proportional floor — enough for
        several patch batches between compactions without inflating the
        per-superstep scan over [K, e_max] at steady state.  When the
        config leaves an axis unset, the compaction policy may raise (never
        shrink) the default from observed update telemetry — slack sized to
        the measured burst instead of to a static guess."""
        e = max(self.sg.n_edges, 1)
        rec_edge, rec_vertex = self.policy.recommend_slack(self)
        edge_slack = self.cfg.edge_slack
        if edge_slack is None:
            edge_slack = max(2 * self.cfg.chunk_size, e // (4 * self.k))
            if rec_edge is not None:
                edge_slack = max(edge_slack, int(rec_edge))
        vertex_slack = self.cfg.vertex_slack
        if vertex_slack is None:
            vertex_slack = max(self.cfg.chunk_size,
                               self.sg.n_vertices // (2 * self.k))
            if rec_vertex is not None:
                vertex_slack = max(vertex_slack, int(rec_vertex))
        return int(edge_slack), int(vertex_slack)

    def _compile(self) -> None:
        g = self.sg.graph()
        edge_slack, vertex_slack = self._slack()
        # on the card compile_plan builds the plan's kernel layouts too
        self.plan = compile_plan(g, self.owner, self.k,
                                 edge_slack=edge_slack,
                                 vertex_slack=vertex_slack, epoch=self.epoch,
                                 device=self.device)
        self._install()

    def _install(self) -> None:
        """Bind the engine to ``self.plan`` (the first plan makes it)."""
        self.engine = Engine(self.plan) if self.engine is None \
            else self.engine.with_plan(self.plan)

    @staticmethod
    def _delta_of(changes: list[EdgeChange]) -> dict:
        """Summarise the graph-content delta of a change batch. Re-auction
        moves (old >= 0 and new >= 0) relocate edges between partitions
        without touching content, so a move-only batch is "none"."""
        ins = sum(c.old < 0 for c in changes)
        dels = sum(c.new < 0 for c in changes)
        moves = len(changes) - ins - dels
        delta = "mixed" if dels else ("insert_only" if ins else "none")
        return {"content_delta": delta, "inserts": ins, "deletes": dels,
                "moves": moves}

    def _recompile(self, delta: dict | None = None,
                   reason: str = "forced") -> None:
        """Compaction epoch: full plan rebuild at new shapes.
        ``delta`` describes the content change the rebuild absorbs (a pure
        compaction changes no content).  ``reason`` is "forced" when the
        rebuild landed mid-apply (slack/slot exhaustion) and "idle" when a
        policy scheduled it into an idle gap."""
        self.epoch += 1
        self.n_recompiles += 1
        if reason == "forced":
            self.n_forced_recompiles += 1
        self._compile()
        self.last_change = {"event": "recompile",
                            **(delta or self._delta_of([]))}
        self.policy.on_compact(self)
        self._notify("recompile")

    # -- session-bound property channels ------------------------------------
    def bind_channel(self, program: str, param: str, values,
                     fill: Callable | None = None) -> None:
        """Bind an external property plane "once per epoch" and keep it
        valid across the session's own mutations.

        ``values``: ``[V, F]`` for vertex channels, ``[n<=e_pad, F]`` in
        graph edge-slot order for edge channels (zero-padded to e_pad
        here).  Edge planes are *maintained*: every inserted edge's row is
        scattered in (``fill(u, v)`` — default zeros) before the plan is
        patched, and a compaction remaps rows by the same slot gather the
        owner array uses.  After each maintenance step the plane is
        re-bound on the registry entry, so new queries pick up a fresh
        content digest — results computed from the old plane are never
        aliased with the new one.  Vertex planes need no maintenance
        (|V| is static); binding them here is pure convenience.
        """
        entry = _registry.get_program(program)
        spec = entry.spec(param)
        if spec.role != "channel":
            raise _registry.ChannelError(
                f"{program}.{param} has role={spec.role!r}, not 'channel' "
                "— only property channels can be bound")
        # validate EVERYTHING before touching the registry: a failed bind
        # must not leave a half-installed plane live for normalize()
        cv = spec.coerce(program, values)
        vals = np.array(cv.values, np.float32)        # mutable working copy
        if spec.channel == "edge":
            if vals.shape[0] > self.sg.e_pad:
                raise _registry.ChannelError(
                    f"{program}.{param}: edge plane has {vals.shape[0]} "
                    f"rows but the streaming graph holds {self.sg.e_pad} "
                    "edge slots")
            if vals.shape[0] < self.sg.e_pad:
                vals = np.concatenate(
                    [vals, np.zeros((self.sg.e_pad - vals.shape[0],
                                     vals.shape[1]), np.float32)])
        owner = _BINDING_OWNERS.get((program, param))
        owner = owner() if owner is not None else None
        if owner is not None and owner is not self:
            raise _registry.ChannelError(
                f"{program}.{param} is already bound and maintained by "
                "another live StreamSession — unbind it there first (one "
                "maintained binding per program param per process)")
        # reuse the already-coerced ChannelValue when padding didn't change
        # the bytes (coercion short-circuits on it: no second copy/hash);
        # the maintenance rebinds below pass raw arrays — ChannelValue
        # always takes a private copy, so the working array is safe as-is
        entry.bind_channel(
            param, cv if vals.shape == cv.values.shape else vals)
        ref = weakref.ref(self)
        _BINDING_OWNERS[(program, param)] = ref
        weakref.finalize(self, _release_binding, (program, param), ref,
                         entry)
        self._channels[(program, param)] = _BoundChannel(
            program, param, spec.channel, spec.features, vals, fill)
        _obs.get().event("stream.channel_bind", program=program,
                         param=param, channel=spec.channel,
                         features=spec.features, rows=vals.shape[0])

    def unbind_channel(self, program: str, param: str) -> None:
        """Release a maintained binding. Owner-checked: a session may only
        release a slot it owns (or a dead/free one) — otherwise one session
        could drop another's live binding and re-open the silent-clobber
        window the ownership map closes."""
        key = (program, param)
        owner = _BINDING_OWNERS.get(key)
        owner = owner() if owner is not None else None
        if owner is not None and owner is not self:
            raise _registry.ChannelError(
                f"{program}.{param} is bound and maintained by another "
                "live StreamSession — only its owner may unbind it")
        self._channels.pop(key, None)
        _BINDING_OWNERS.pop(key, None)
        _registry.get_program(program).unbind_channel(param)

    def _channel_scatter(self, changes: list[EdgeChange]) -> None:
        """Scatter inserted edges' feature rows into every bound edge
        plane (and re-bind, bumping the content digest). Runs before the
        plan is installed so patch and recompile paths see identical
        planes — patched == recompiled."""
        inserts = [c for c in changes if c.old < 0 and c.slot >= 0]
        if not inserts:
            return
        for bc in self._channels.values():
            if bc.channel != "edge":
                continue
            for c in inserts:
                row = (np.zeros(bc.features, np.float32) if bc.fill is None
                       else np.asarray(bc.fill(c.u, c.v),
                                       np.float32).reshape(bc.features))
                bc.values[c.slot] = row
            _registry.get_program(bc.program).bind_channel(
                bc.param, bc.values)
            _obs.get().event("stream.channel_rebind", program=bc.program,
                             param=bc.param, reason="insert_scatter",
                             rows=len(inserts))

    def _channel_remap(self, keep: np.ndarray) -> None:
        """Compaction epoch: remap every bound edge plane by the same slot
        gather the owner array uses, re-padded to the fresh e_pad."""
        for bc in self._channels.values():
            if bc.channel != "edge":
                continue
            vals = np.zeros((self.sg.e_pad, bc.features), np.float32)
            vals[:len(keep)] = bc.values[keep]
            bc.values = vals
            _registry.get_program(bc.program).bind_channel(
                bc.param, vals)
            _obs.get().event("stream.channel_rebind", program=bc.program,
                             param=bc.param, reason="compaction_remap",
                             rows=len(keep))

    def _patch(self, changes: list[EdgeChange]) -> None:
        if not changes:
            return
        self._channel_scatter(changes)
        delta = self._delta_of(changes)
        rec = _obs.get()
        try:
            with rec.span("stream.patch_plan", changes=len(changes)):
                plan = patch_plan(self.plan, changes)
            if plan.device.type == "cuda":
                with rec.span("stream.layouts"):
                    build_layouts(plan)
            self.plan = plan
            self._install()
            self.n_patches += 1
            self.last_change = {"event": "patch", **delta}
            self._notify("patch")
        except SlackExhausted:
            self._recompile(delta)

    # -- update ingestion ---------------------------------------------------
    def apply(self, inserts=None, deletes=None) -> dict:
        """Ingest a batch of edge updates; returns maintenance stats."""
        inserts = np.zeros((0, 2), np.int64) if inserts is None else inserts
        deletes = np.zeros((0, 2), np.int64) if deletes is None else deletes
        with _obs.get().span("stream.apply", inserts=len(inserts),
                             deletes=len(deletes)):
            return self._apply(inserts, deletes)

    def _apply(self, inserts, deletes) -> dict:
        cfg = self.cfg
        t_apply = time.perf_counter()
        n_inserts_req = len(inserts)
        n_updates_req = n_inserts_req + len(deletes)
        changes: list[EdgeChange] = []

        u_live, v_live, live = self.sg.live_edges()
        own_live = self.owner[live]
        presence, sizes, degrees = assign.seed_state(
            u_live, v_live, own_live, self.sg.n_vertices, self.k)

        for chunk in iter_chunks(deletes, cfg.chunk_size):
            res = self.sg.delete_chunk(chunk)
            for s, a, b in zip(res.slots.tolist(), res.u.tolist(),
                               res.v.tolist()):
                changes.append(EdgeChange(a, b, int(self.owner[s]), -1, s))
                self.owner[s] = -2
                self.touched[a] = self.touched[b] = True
            self.n_ingested += len(res.slots)

        for chunk in iter_chunks(inserts, cfg.chunk_size):
            if self.sg.free_slots() < len(chunk):
                # graph out of spare slots: compaction epoch (owner remaps
                # by the slot gather compact() returns, plan rebuilds)
                self._flush_via_compaction(changes)
                changes = []
            res = self.sg.insert_chunk(chunk)
            owners = assign.hdrf_assign(res.u, res.v, presence, sizes,
                                        degrees, lam=cfg.hdrf_lambda)
            for s, a, b, p in zip(res.slots.tolist(), res.u.tolist(),
                                  res.v.tolist(), owners.tolist()):
                self.owner[s] = p
                changes.append(EdgeChange(a, b, -1, int(p), s))
                self.touched[a] = self.touched[b] = True
            self.n_ingested += len(res.slots)

        self._patch(changes)

        reauction_info = self._reauction() if self._drifted() else None
        # feed the policy's telemetry: requested counts (dedup/no-op skips
        # included — they are offered load) + the batch's wall duration
        self.policy.on_apply(self, n_updates_req, n_inserts_req,
                             time.perf_counter() - t_apply)
        return {"epoch": self.epoch, "patches": self.n_patches,
                "recompiles": self.n_recompiles,
                "forced_recompiles": self.n_forced_recompiles,
                "idle_compactions": self.n_idle_compactions,
                "reauctions": self.n_reauctions,
                "rf": self.plan.replication_factor(),
                "rf_base": self.rf_base, "reauction": reauction_info}

    def _flush_via_compaction(self, pending: list[EdgeChange],
                              reason: str = "forced") -> None:
        """Compact the graph's slot space; pending patch changes are
        absorbed by the recompile (owner already reflects them)."""
        self._channel_scatter(pending)   # pending inserts' rows, old space
        delta = self._delta_of(pending)
        keep = self.sg.compact(headroom_frac=self.cfg.compaction_headroom)
        _obs.get().event("stream.compaction", kept=len(keep),
                         e_pad=self.sg.e_pad, epoch=self.epoch + 1,
                         reason=reason)
        owner = np.full(self.sg.e_pad, -2, np.int32)
        owner[:len(keep)] = self.owner[keep]
        self.owner = owner
        self._channel_remap(keep)
        self._recompile(delta, reason=reason)

    def idle_tick(self) -> bool:
        """Give the compaction policy an idle gap: compacts (and recompiles
        with policy-recommended slack) when the policy says the remaining
        headroom could not absorb the observed burst pattern.  Returns
        whether a compaction ran — the recompile is paid HERE, in the gap,
        pre-empting a forced one mid-burst.  Serving layers call
        this between drains; it is cheap when the policy declines."""
        if not self.policy.should_compact(self):
            return False
        self.n_idle_compactions += 1
        with _obs.get().span("stream.idle_compaction"):
            self._flush_via_compaction([], reason="idle")
        return True

    # -- drift-triggered local re-auction -----------------------------------
    def _drifted(self) -> bool:
        rf_now = self.plan.replication_factor()
        return (bool(self.touched.any())
                and rf_now > (1.0 + self.cfg.drift_threshold) * self.rf_base)

    def _reauction(self) -> dict:
        new_owner, info = reauction.local_reauction(
            self.sg.graph(), self.owner, self.touched, self.k,
            hops=self.cfg.hops, max_rounds=self.cfg.reauction_max_rounds)
        u, v, mask = self.sg.slot_arrays()
        moved = np.flatnonzero((new_owner != self.owner) & mask)
        changes = [EdgeChange(int(u[s]), int(v[s]), int(self.owner[s]),
                              int(new_owner[s]), int(s)) for s in moved]
        self.owner = np.array(new_owner, np.int32)
        _obs.get().event(
            "stream.reauction", moves=len(changes),
            **{k: v for k, v in info.items()
               if isinstance(v, (int, float, bool, str))})
        self._patch(changes)
        self.n_reauctions += 1
        self.touched[:] = False
        # re-baseline: drift is measured against the last correction point
        self.rf_base = self.plan.replication_factor()
        return info

    # -- queries ------------------------------------------------------------
    def graph(self):
        return self.sg.graph()

    def replication_factor(self) -> float:
        return self.plan.replication_factor()
