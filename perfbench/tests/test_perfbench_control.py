"""``correct`` can come out false: the control (the reference one
precision lower in the program's place) and each fault a cell can have,
planted under the timed path of a whole CPU run at a small size."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import checks, control, harness
from perfbench.tests import tiny

SERVE = "ba317k-k16.sssp-lanes"
PART = "ba317k-k16.partition"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tiny.one_thread():
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [SERVE, PART])
def test_the_bfloat16_control_is_not_correct(root, cell):
    for seed in (11, 12, 13):
        got = control.control(root, cell, seed, "cpu")
        got.pop("checked", None)
        ok, got = checks.verdict(got)
        assert not ok, got


def _run(root, cell):
    return harness.execute(root, cell, 7, 0.15, False, "cpu",
                           time.perf_counter())


def test_sound_runs_are_correct(root):
    assert _run(root, SERVE)["correct"] is True
    assert _run(root, PART)["correct"] is True


def _unchanged_sweep(orig):
    """A local sweep that aggregates nothing: every min step returns its
    state unchanged."""
    def sweep(plan, prog, state, ctx, **kw):
        return torch.full_like(orig(plan, prog, state, ctx, **kw),
                               float("inf"))
    return sweep


def _half_batch(orig):
    """Only the first half of a micro-batch's lanes computed; the rest
    answered with the first lane's state."""
    def dispatch_batched(self, prog, batched_kw, *a, **kw):
        n = int(next(iter(batched_kw.values())).shape[0])
        half = {k: v[:max(1, n // 2)] for k, v in batched_kw.items()}
        res = orig(self, prog, half, *a, **kw)
        state, ss, li, conv = res._arrays
        pad = n - state.shape[0]
        if pad:
            state = torch.cat([state, state[:1].expand(pad, -1)])
            ss, li, conv = (torch.cat([t, t[:1].expand(pad)])
                            for t in (ss, li, conv))
        return dataclasses.replace(res, _arrays=(state, ss, li, conv))
    return dispatch_batched


def _altered(orig):
    """Each answer altered where the server copies it to the host."""
    def host(a):
        out = orig(a).copy()
        if out.dtype == np.float32 and out.ndim == 2:
            out[:, -1] += 1.0
        return out
    return host


def _moved_edge(orig):
    """The program's graph drawn with one edge moved to another vertex."""
    def load_dataset(*a, **kw):
        g = orig(*a, **kw)
        dst = g.dst.clone()
        dst[0] = (dst[0] + 1) % g.n_vertices
        return dataclasses.replace(g, dst=dst)
    return load_dataset


def test_serving_faults_make_correct_false(root, monkeypatch):
    from repro_torch.core import graph
    from repro_torch.engine import runtime
    from repro_torch.gserve import server
    faults = {
        "the graph altered where it is drawn":
            (graph, "load_dataset", _moved_edge(graph.load_dataset)),
        "step returns its state unchanged":
            (runtime, "_sweep", _unchanged_sweep(runtime._sweep)),
        "half of the batch left out":
            (runtime.Engine, "dispatch_batched",
             _half_batch(runtime.Engine.dispatch_batched)),
        "the exchange between partitions left out":
            (runtime, "_exchange", lambda plan, values, combine, **kw:
             values),
        "an answer altered where it is produced":
            (server, "_host", _altered(server._host)),
    }
    for name, (obj, attr, fn) in faults.items():
        with monkeypatch.context() as m:
            m.setattr(obj, attr, fn)
            out = _run(root, SERVE)
        assert out["correct"] is False, name


def test_partition_faults_make_correct_false(root, monkeypatch):
    from repro_torch.core import dfep, graph

    def unchanged(g, slots, cfg, state, *a, **kw):
        one = torch.ones((), dtype=torch.int32)
        return dataclasses.replace(state, rounds=state.rounds + one,
                                   stalled=state.stalled + one)

    orig = dfep.partition

    def altered(*a, **kw):
        owner, info = orig(*a, **kw)
        owner = owner.clone()
        live = torch.nonzero(owner >= 0)[0, 0]
        owner[live] = (owner[live] + 1) % 4
        return owner, info

    for name, obj, attr, fn in [
            ("step returns its state unchanged", dfep, "_round", unchanged),
            ("an owner altered where it is produced", dfep, "partition",
             altered),
            ("the graph altered where it is drawn", graph, "load_dataset",
             _moved_edge(graph.load_dataset))]:
        with monkeypatch.context() as m:
            m.setattr(obj, attr, fn)
            out = _run(root, PART)
        assert out["correct"] is False, name
