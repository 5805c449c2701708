"""What one run measured, for the metric readers (``metrics/<name>.py``).

A driver fills a :class:`Run`; each reader takes it and returns its number,
or None where the run has nothing for it to read.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    #: process start to the first timed operation
    setup_s: float = 0.0
    #: wall seconds of each set-up step, in order
    setup_phases: dict = dataclasses.field(default_factory=dict)
    #: DFEP's wall seconds inside set-up (serving cells)
    dfep_setup_s: float | None = None
    #: the window's wall seconds (a partition window stretches to finish
    #: the last partition it started)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    #: serving: submit-to-host seconds of each query completed in the window
    latencies: list = dataclasses.field(default_factory=list)
    #: serving: the server's own counts over the window (``ServeMetrics``)
    serve: dict = dataclasses.field(default_factory=dict)
    #: serving: [seconds into the window, completed, batches, lanes used,
    #: device seconds] of the server's counts, at every ``stretch_s``
    stretches: list = dataclasses.field(default_factory=list)
    #: partitioning: one dict a partition: seconds, rounds, traced
    partitions: list = dataclasses.field(default_factory=list)
    #: the program's recorder counters over the window (traced runs)
    counters: dict = dataclasses.field(default_factory=dict)
    #: the profiler's reading of the traced part of the window
    #: (:class:`perfbench.tracing.TraceSummary`), None when untraced
    profile: Any = None
    #: kernel launches in the traced part: (lane width, {kernel: launches})
    #: a micro-batch, or (rounds, {kernel: launches}) a partition
    launches: list = dataclasses.field(default_factory=list)
    #: shapes the byte counts need: plan counts, |V|, slots
    sizes: dict = dataclasses.field(default_factory=dict)
