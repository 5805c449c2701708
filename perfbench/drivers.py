"""The general traffic generator and the window's two drivers.

A traffic mix (``traffic/<mix>.json``) names its ``driver`` and gives its
parameters; nothing else about a mix lives in code:

``closed_loop``
    ``clients`` clients in ``tenants`` tenants, each with one query
    outstanding: it draws a single-source program by ``programs[].weight``
    and a source vertex uniformly over the vertices, submits, waits for its
    answer and sends the next. ``server`` holds the ``GraphServer``'s
    buckets, cache and queue. The set-up partitions the graph with DFEP,
    compiles the plan, runs one superstep of every program at every
    bucket's lane count through the engine, then the loop for
    ``warmup_s``, long enough to fill the server's store of recent results,
    so that the window sees a server in its steady state; the window runs
    the loop for the measured seconds, and keeps the server's counts at
    every ``stretch_s`` of it. Each query is kept for the check with
    probability ``check.share``, up to ``check.max`` of them.

``partitions``
    Whole DFEP partitions back to back, each from K start vertices drawn
    from the seed, each ending in its owner array on the card. The set-up
    runs one partition of ``warmup_rounds`` rounds; the window stretches to
    finish the last partition it started. ``check.partitions`` of them,
    drawn from the seed, are held against the frozen DFEP.

Every draw comes from ``--seed``: the graph, the start vertices, each
client's stream and the sample that is checked. Each set-up step's wall
seconds are kept in ``Run.setup_phases``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function as span

from . import bounds, checks
from .record import Run
from .tracing import Tracer

# independent streams of one seed
DFEP, WARM, CLIENT, SAMPLE, PARTS = range(5)
#: how long a run waits past the window's close for a late answer
LATE_S = 60.0


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *stream]))


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def make_graph(config: dict, seed: int, device):
    """The configuration's graph from the seed: the program's generator, on
    the host, then moved to ``device``."""
    from repro_torch.core import graph
    with span("bench.load_dataset"):
        return graph.load_dataset(config["dataset"], scale=config["scale"],
                                  seed=int(seed) % 2**63, device=device)


def host_graph(g) -> tuple:
    """The program's graph as the check reads it: (n_vertices, src, dst,
    mask) on the host."""
    return (g.n_vertices, g.src.cpu().numpy(), g.dst.cpu().numpy(),
            g.edge_mask.cpu().numpy())


class Phases:
    """Wall seconds of each set-up step, into ``Run.setup_phases``."""

    def __init__(self, run: Run, device):
        self.run, self.device = run, device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.run.setup_phases[name] = now - self.t
        self.t = now


def dfep_kwargs(config: dict) -> dict:
    d = config["dfep"]
    if d["variant"] != "dfep":      # the frozen reference has no DFEP-C
        raise ValueError(f"unsupported DFEP variant {d['variant']!r}")
    return {"cap": d["cap"], "max_rounds": d["max_rounds"],
            "stall_rounds": d["stall_rounds"]}


def draw_starts(gen: np.random.Generator, n: int, k: int) -> list[int]:
    return [int(s) for s in gen.choice(n, size=k, replace=False)]


def free_device(device) -> None:
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# closed loop of graph queries
# ---------------------------------------------------------------------------

class _Client:
    def __init__(self, tenant: str, gen: np.random.Generator):
        self.tenant, self.gen = tenant, gen
        self.query = None          # (request, program, source, t_submit, keep)


class ClosedLoop:
    def __init__(self, traffic: dict, n_vertices: int, seed: int):
        self.programs = traffic["programs"]
        w = np.array([p["weight"] for p in self.programs], float)
        self.cum = np.cumsum(w / w.sum())
        self.n_vertices = n_vertices
        t = traffic["tenants"]
        self.clients = [_Client(f"t{i % t}", rng(seed, CLIENT, i))
                        for i in range(traffic["clients"])]
        self.share = traffic["check"]["share"]
        self.inflight: dict = {}
        self.refused = 0

    def request(self, client: _Client):
        from repro_torch import gserve as G
        gen = client.gen
        p = self.programs[int(np.searchsorted(self.cum, gen.random(),
                                              side="right"))]
        source = int(gen.integers(self.n_vertices))
        keep = gen.random() < self.share
        return G.QueryRequest(p["program"], tenant=client.tenant,
                              params={"source": source}), \
            p["program"], source, keep

    def submit(self, server, client: _Client) -> None:
        from repro_torch.gserve import AdmissionError
        req, prog, source, keep = self.request(client)
        t = time.perf_counter()
        try:
            server.submit(req)
        except AdmissionError:
            self.refused += 1
            client.query = None
            return
        client.query = (req, prog, source, t, keep)
        self.inflight[req.id] = client


def _lane_width(server) -> int:
    return server.metrics.n_lanes_dispatched


def closed_loop(run: Run, device, t_start: float) -> dict:
    """Serve the mix for the window; returns the check's numbers."""
    from repro_torch import engine as E
    from repro_torch import gserve as G
    from repro_torch import obs
    from repro_torch.core import dfep
    from repro_torch.engine import kernels as EK
    cfg, traffic, seed = run.config, run.traffic, run.seed
    phases = Phases(run, device)
    g = make_graph(cfg, seed, device)
    phases.mark("graph")
    k = cfg["k"]
    with span("bench.dfep.partition"):
        owner, _ = dfep.partition(
            g, k, starts=draw_starts(rng(seed, DFEP), g.n_vertices, k),
            device=device, **dfep_kwargs(cfg))
    phases.mark("dfep")
    run.dfep_setup_s = run.setup_phases["dfep"]
    plan = E.compile_plan(g, owner, k, device=device)
    run.sizes["plan"] = bounds.plan_counts(plan)
    sv = traffic["server"]
    server = G.GraphServer(E.Engine(plan), g, buckets=tuple(sv["buckets"]),
                           cache_entries=sv["cache_entries"],
                           max_pending=sv["max_pending"])
    loop = ClosedLoop(traffic, g.n_vertices, seed)

    # every shape the window meets: each program at each lane count of the
    # server's buckets, one superstep through the engine's batched entry
    # (the shapes are the lane count's, however many supersteps run), then
    # the whole serving path under the mix's own loop
    warm = rng(seed, WARM)
    eng = server.front.engine
    for p in loop.programs:
        prog = E.get_program(p["program"]).program
        for b in server.buckets:
            lanes = torch.as_tensor(warm.integers(g.n_vertices, size=b),
                                    dtype=torch.int32, device=device)
            eng.dispatch_batched(prog, {"source": lanes},
                                 max_supersteps=1).result()
    phases.mark("plan_and_shapes")
    for c in loop.clients:
        loop.submit(server, c)
    _serve(server, loop, time.perf_counter() + traffic["warmup_s"], None,
           None, run)
    phases.mark("warmup_traffic")

    samples: list = []
    lat: list = []
    late = [0]
    tracer = Tracer(device) if run.trace else None
    server.metrics.reset()
    if run.trace:
        obs.reset()
        obs.enable()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    t_end = t0 + run.seconds
    loop.refused = 0
    trace_end = None
    if tracer:
        tracer.start()
        trace_end = time.perf_counter() + traffic["trace_s"]

    def done(res, now, in_window):
        client = loop.inflight.pop(res.request.id, None)
        if client is None:
            return
        req, prog, source, t_sub, keep = client.query
        client.query = None
        if res.error is not None:
            run.failed += 1
        elif keep and len(samples) < traffic["check"]["max"]:
            samples.append((prog, source, res.value))
        if in_window:
            lat.append(now - t_sub)
        else:
            late[0] += 1

    _serve(server, loop, t_end, done, (tracer, trace_end, EK.LAUNCHES),
           run, (t0, traffic["stretch_s"]))
    run.window_s = time.perf_counter() - t0
    m = server.metrics
    run.serve = {"batches": m.n_batches, "lanes_used": m.n_lanes_used,
                 "lanes_dispatched": m.n_lanes_dispatched,
                 "device_time_s": m.device_time_s, "executes": m.n_executes,
                 "cache_hits": m.n_cache_hits}
    if run.trace:
        run.counters = obs.get().counters()
        obs.disable()
        obs.reset()
    # late answers: every query still outstanding at the close
    deadline = time.perf_counter() + LATE_S
    while loop.inflight and time.perf_counter() < deadline:
        now_res = server.pump()
        now = time.perf_counter()
        for r in now_res:
            done(r, now, False)
        if not now_res and not server.pending():
            break
    unanswered = len(loop.inflight)
    run.latencies = lat
    run.attempted = len(lat) + late[0] + unanswered + loop.refused
    run.failed += unanswered + loop.refused
    run.sizes["memory_peak_bytes"] = _peak(device)
    program_graph = host_graph(g)
    server.close()
    del server, plan, owner, g
    free_device(device)
    edges, mismatch = checks.reference_graph(cfg, seed, program_graph)
    checked, wrong = checks.wrong_answers(edges, samples, device)
    run.sizes["checked"] = checked
    return {"graph_mismatch": mismatch, "wrong_answers": wrong,
            "failed_queries": run.failed}


def _serve(server, loop: ClosedLoop, until: float, done, tracing, run,
           stretches=None):
    """Pump micro-batches until ``until``; each answered client sends its
    next query, in the window only before ``until`` and in the warm-up
    (``done`` None) always, so that the loop runs on into the window.
    ``done`` sees every answer; with ``tracing`` the profiler runs until
    its end, and each micro-batch's lane width and kernel launches are kept
    for the rooflines. ``stretches`` = (t0, seconds): the server's counts
    are kept in ``run.stretches`` at every ``seconds`` past ``t0``."""
    tracer, trace_end, launches = tracing or (None, None, None)
    tracing_on = tracer is not None
    if stretches:
        t0, every = stretches
        mark = t0 + every
    while True:
        if tracing_on:
            before = dict(launches)
            w0 = _lane_width(server)
        with span("bench.pump"):
            res = server.pump()
        now = time.perf_counter()
        if tracing_on:
            run.launches.append((_lane_width(server) - w0,
                                 {n: launches[n] - before.get(n, 0)
                                  for n in launches}))
            if now >= trace_end:
                run.profile = tracer.stop()
                tracing_on = False
        with span("bench.submit"):
            for r in res:
                client = loop.inflight.get(r.request.id)
                if client is None:
                    continue
                if done is not None:
                    done(r, now, now <= until)
                else:
                    loop.inflight.pop(r.request.id)
                if done is None or now < until:
                    loop.submit(server, client)
        if stretches and now >= mark:
            m = server.metrics
            run.stretches.append([now - t0, m.n_completed, m.n_batches,
                                  m.n_lanes_used, m.device_time_s])
            mark += every
        if now >= until or (not res and not server.pending()):
            break
    if tracing_on:
        run.profile = tracer.stop()


def _peak(device) -> int:
    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


# ---------------------------------------------------------------------------
# whole partitions back to back
# ---------------------------------------------------------------------------

def partitions(run: Run, device, t_start: float) -> dict:
    """Partition for the window; returns the check's numbers."""
    from repro_torch.core import dfep
    from repro_torch.kernels import ops
    cfg, traffic, seed = run.config, run.traffic, run.seed
    phases = Phases(run, device)
    g = make_graph(cfg, seed, device)
    phases.mark("graph")
    k = cfg["k"]
    kw = dfep_kwargs(cfg)
    run.sizes.update(vertices=g.n_vertices, slots=2 * g.e_pad, k=k)
    draws = rng(seed, PARTS)
    with span("bench.dfep.partition"):
        dfep.partition(g, k, starts=draw_starts(rng(seed, WARM),
                                                g.n_vertices, k),
                       device=device,
                       **{**kw, "max_rounds": traffic["warmup_rounds"]})
    phases.mark("warmup_partition")
    tracer = Tracer(device) if run.trace else None
    done = []
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    while not done or time.perf_counter() < t0 + run.seconds:
        starts = draw_starts(draws, g.n_vertices, k)
        traced = tracer is not None and not done
        if traced:
            before = dict(ops.LAUNCHES)
            tracer.start()
        t = time.perf_counter()
        with span("bench.dfep.partition"):
            owner, info = dfep.partition(g, k, starts=starts, device=device,
                                         **kw)
            sync(device)
        dt = time.perf_counter() - t
        if traced:
            run.profile = tracer.stop()
            run.launches.append((info["rounds"],
                                 {n: ops.LAUNCHES[n] - before.get(n, 0)
                                  for n in ops.LAUNCHES}))
        done.append((starts, owner, info["rounds"]))
        run.partitions.append({"seconds": dt, "rounds": info["rounds"],
                               "traced": traced})
    run.window_s = time.perf_counter() - t0
    run.attempted = len(done)
    run.sizes["memory_peak_bytes"] = _peak(device)
    pick = rng(seed, SAMPLE).choice(len(done),
                                     size=min(traffic["check"]["partitions"],
                                              len(done)), replace=False)
    kept = [(done[i][0], done[i][1].cpu().numpy(), done[i][2])
            for i in sorted(pick)]
    program_graph = host_graph(g)
    del done, owner, g
    free_device(device)
    edges, graph_mismatch = checks.reference_graph(cfg, seed, program_graph)
    mismatch = gap = 0
    for starts, owner, rounds in kept:
        m, r = checks.partition_gaps(edges, k, starts, owner, rounds,
                                     cfg["dfep"], device)
        mismatch, gap = mismatch + m, max(gap, r)
    run.sizes["checked"] = len(kept)
    return {"graph_mismatch": graph_mismatch, "owner_mismatch": mismatch,
            "rounds_gap": gap}


DRIVERS = {"closed_loop": closed_loop, "partitions": partitions}
