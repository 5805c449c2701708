"""The comparisons that decide ``correct``.

The program's graph is held slot for slot against the benchmark's own
draw of it (``reference/graphgen.py``), and the references work on that
draw alone. Served answers are held against the plain reference of their
program (``reference/<program>.py``, found by the program's name);
partitions against the frozen DFEP (``reference/dfep.py``). Every
comparison is exact, so every limit is 0: the program draws the same
graph, computes the same float32 min-plus fixpoints and the same integer
auction as its reference, and any difference is a wrong answer. The
limits were set from the readings given in ``PERF.md``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import EdgeList, graphgen
from .reference import dfep as ref_dfep

LIMITS = {
    # slots where the program's graph differs from the benchmark's draw
    "graph_mismatch": 0,
    # served queries whose [V] answer differs anywhere from the reference's
    "wrong_answers": 0,
    # queries refused, failed, or never answered within a minute past close
    "failed_queries": 0,
    # edges whose owner differs from the reference DFEP's
    "owner_mismatch": 0,
    # |rounds - the reference DFEP's rounds|
    "rounds_gap": 0,
}


def reference_graph(config: dict, seed: int, program_graph: tuple):
    """(the benchmark's own draw of the cell's graph, graph_mismatch):
    ``program_graph`` is the program's (n_vertices, src, dst, mask) as host
    arrays."""
    want = graphgen.make(config["graph"], config["scale"], seed)
    return want, graphgen.slot_mismatch(want, *program_graph)


def reference(program: str):
    """The reference module of a served program."""
    return importlib.import_module(f"{__package__}.reference.{program}")


def wrong_answers(edges: EdgeList, samples: list, device,
                  dtype=torch.float32) -> tuple[int, int]:
    """(checked, wrong) over ``samples``, a list of (program, source,
    value [V]): the reference answers each program's sources in blocks
    (computed in ``dtype``), and an answer is wrong where any entry differs
    (``inf`` equals ``inf``)."""
    by_kind: dict[str, list] = {}
    for kind, source, value in samples:
        by_kind.setdefault(kind, []).append((source, value))
    wrong = 0
    for kind, rows in by_kind.items():
        srcs = np.array([s for s, _ in rows], np.int64)
        want = reference(kind).solve(edges, srcs, dtype=dtype,
                                     device=device).cpu().numpy()
        for (_, got), ref in zip(rows, want):
            got = np.asarray(got)
            if got.shape != ref.shape or not np.array_equal(got, ref):
                wrong += 1
    return len(samples), wrong


def partition_gaps(edges: EdgeList, k: int, starts, owner: np.ndarray,
                   rounds: int, dfep_cfg: dict, device,
                   dtype=torch.float32) -> tuple[int, int]:
    """(owner_mismatch, rounds_gap) of one partition against the frozen
    DFEP from the same start vertices."""
    want, want_rounds = ref_dfep.partition(
        edges, k, starts, cap=dfep_cfg.get("cap", 10),
        max_rounds=dfep_cfg["max_rounds"],
        stall_rounds=dfep_cfg["stall_rounds"], dtype=dtype, device=device)
    owner = np.asarray(owner)
    mismatch = (int((owner != want).sum()) if owner.shape == want.shape
                else int(want.size))
    return mismatch, abs(int(rounds) - int(want_rounds))


def verdict(numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the compared numbers."""
    out = {n: {"value": v, "limit": LIMITS[n]} for n, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
