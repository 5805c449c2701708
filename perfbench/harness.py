"""Run one cell of ``BENCHMARK.json`` and print its result line.

The cell names its configuration and traffic mix; the harness finds each by
name: the configuration at the ``file`` ``BENCHMARK.json`` gives it, the mix
at ``perfbench/traffic/<mix>.json``, each metric's reader at
``perfbench/metrics/<metric>.py``. The mix's ``driver`` (``drivers.py``)
sets the cell up, runs the window and returns the numbers the check
compares. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from a separate, traced run.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last ``checks``:
each compared number beside its limit, which also end standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import checks
from .record import Run

#: top-level module names the process must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, root: Path, workload: str) -> dict:
    """The cell ``workload`` with its configuration, traffic and the
    metrics it reports: {"cell", "config", "traffic", "end_to_end",
    "per_layer"}."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def reader(root: Path, name: str):
    """The ``read(run)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: the loaded modules) that
    are forbidden, compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device, run: Run) -> dict:
    import torch
    if str(device).startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(run.sizes.get("memory_peak_bytes", 0))
    if run.trace and run.profile is not None:
        info["busy_s"] = run.profile.busy_s
        info["window_s"] = run.profile.window_s
    return info


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device, t_start: float) -> dict:
    """Run the cell on ``device`` and return its result line."""
    from . import drivers
    cell = resolve(load_spec(root), root, workload)
    run = Run(cell=workload, config=cell["config"], traffic=cell["traffic"],
              seed=int(seed), seconds=float(seconds), trace=bool(trace))
    t = time.perf_counter()
    run.setup_phases["start"] = t - t_start
    if str(device).startswith("cuda"):
        from repro_torch import cuda_build
        cuda_build.build()        # every kernel, before anything is timed
    run.setup_phases["kernels"] = time.perf_counter() - t
    numbers = drivers.DRIVERS[run.traffic["driver"]](run, device, t_start)
    correct, compared = checks.verdict(numbers)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": device_info(device, run)}
    if trace and run.profile is not None:
        out["breakdown"] = run.profile.breakdown()
    out["checks"] = compared
    print("setup_phases " + json.dumps(run.setup_phases), file=sys.stderr)
    if run.stretches:
        print("stretches " + json.dumps(run.stretches), file=sys.stderr)
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: Path, t_start: float) -> int:
    args = parse(argv)
    cell = resolve(load_spec(root), root, args.workload)
    import torch
    chips = int(cell["cell"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    out = execute(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
