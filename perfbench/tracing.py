"""The profiler over the traced part of a window, reduced to what the
metrics and the ``breakdown`` need.

``torch.profiler`` records host ops (with the benchmark's own spans around
each call into the program, ``bench.*``) and, on the card, every kernel,
copy and set of memory through CUPTI. :class:`TraceSummary` keeps: the
device's busy seconds (the union of its operations' intervals), each
device operation's count and seconds by name, and the idle gaps between
device operations named by the innermost host op running at each gap's
middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

#: gaps shorter than this are launch latency, not idleness worth naming
_GAP_MIN_NS = 10_000
#: how many of the longest gaps are named (the rest only counted)
_GAPS_NAMED = 4000
#: how far back a gap's name is looked for among earlier host ops
_SCAN_BACK = 4000


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: device operation name -> (count, seconds)
    device_ops: dict
    #: host op name -> idle seconds of the gaps it was running in
    idle_by_host: dict

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(launches, seconds) of the device operations whose name holds
        ``pattern``."""
        n, s = 0, 0.0
        for name, (c, t) in self.device_ops.items():
            if pattern in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, t] for n, (_, t) in ops[:10]],
                "idle_gaps": [[n, t] for n, t in gaps[:10]]}


class Tracer:
    """Start and stop the profiler around part of a window. Making one
    profiles a moment of idleness first, so that the profiler's own start
    (seconds, the first time in a process) falls into the set-up."""

    def __init__(self, device: str):
        self.cuda = str(device).startswith("cuda")
        self._acts = [ProfilerActivity.CPU]
        if self.cuda:
            self._acts.append(ProfilerActivity.CUDA)
        with profile(activities=self._acts):
            self._sync()
        self._prof = profile(activities=self._acts)
        self._t0 = 0.0
        self.summary: TraceSummary | None = None

    def start(self) -> None:
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> TraceSummary:
        self._sync()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.summary = summarize(self._prof, window)
        return self.summary

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list (the first
    ``(`` right after a name, outside template brackets), at most 160
    characters: the template arguments stay, they tell kernels apart."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<[":
            depth += 1
        elif ch in ">]":
            depth -= 1
        elif (ch == "(" and depth == 0 and i > 0
              and (name[i - 1].isalnum() or name[i - 1] in "_>")):
            name = name[:i]
            break
    return name[:160]


def _events(prof):
    """(device, host) event lists of (start_ns, end_ns, name)."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(rec)
        elif not e.is_user_annotation():
            # a host span is mirrored on the device's timeline over the
            # device work it launched: it is not an operation
            dev.append((rec[0], rec[1], short_name(rec[2])))
    return dev, host


def summarize(prof, window_s: float) -> TraceSummary:
    dev, host = _events(prof)
    ops: dict[str, list] = {}
    for s, e, name in dev:
        c = ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) * 1e-9
    busy, gaps = 0.0, []
    if dev:
        iv = np.array([(s, e) for s, e, _ in dev], np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        # merge overlapping intervals: a new run starts where an interval
        # begins after every earlier one has ended
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
        busy = float((run_end - starts).sum()) * 1e-9
        g0, g1 = run_end[:-1], starts[1:]
        keep = (g1 - g0) >= _GAP_MIN_NS
        gaps = list(zip(g0[keep].tolist(), g1[keep].tolist()))
    return TraceSummary(window_s=window_s, busy_s=busy,
                        device_ops={n: (c, t) for n, (c, t) in ops.items()},
                        idle_by_host=_name_gaps(gaps, host))


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host op covering each gap's middle:
    among ops that started before it and end after it, the latest to
    start."""
    host.sort()
    starts = [s for s, _, _ in host]
    out: dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for i, (g0, g1) in enumerate(gaps):
        if i >= _GAPS_NAMED:
            name = "(not named: shorter gaps)"
        else:
            mid = (g0 + g1) // 2
            name = "(no host op)"
            j = bisect.bisect_right(starts, mid) - 1
            stop = max(-1, j - _SCAN_BACK)
            while j > stop:
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
                j -= 1
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out
