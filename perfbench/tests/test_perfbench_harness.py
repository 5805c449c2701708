"""The harness on the CPU: cells resolve from their files, the result line
has the contract's keys, a new configuration, mix and metric need only new
files, and nothing the harness loads is JAX or the JAX package."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests import tiny

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tiny.one_thread():
        yield


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).exists()
        names.add(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for n in names | set(CELLS):
        assert NAME.match(n)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_from_its_files(cell):
    got = harness.resolve(SPEC, REPO, cell)
    assert got["traffic"]["driver"] in ("closed_loop", "partitions")
    e2e = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert got["per_layer"]
    for m in got["end_to_end"] + got["per_layer"]:
        assert callable(harness.reader(REPO, m["name"]))
    for m in got["per_layer"]:      # each moves a metric the cell reports
        assert m["moves"] in e2e


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _keys_in_order(out, traced):
    return list(out) == KEYS + (["breakdown"] if traced else []) + ["checks"]


@pytest.mark.parametrize("cell,trace", [("ba317k-k16.sssp-lanes", 0),
                                        ("ba317k-k16.sssp-lanes", 1),
                                        ("ba317k-k16.partition", 0)])
def test_result_line_has_the_contract_keys(root, cell, trace):
    out = harness.execute(root, cell, 2**31 + 17, 0.2, bool(trace), "cpu",
                          time.perf_counter())
    assert _keys_in_order(out, trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = harness.resolve(tiny.spec(root), root, cell)
    listed = {m["name"] for m in want["per_layer" if trace else
                                      "end_to_end"]}
    assert set(out["metrics"]) <= listed
    if not trace:       # the end-to-end metrics are never missing
        assert set(out["metrics"]) == listed
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_a_new_config_mix_and_metric_need_only_new_files(root, tmp_path):
    """A dummy configuration, traffic mix and per-layer metric, added as
    files and entries alone, run through the unchanged harness."""
    import shutil
    shutil.copytree(root, tmp_path / "r")
    r = tmp_path / "r"
    spec = tiny.spec(r)
    cfg = json.loads((r / "perfbench/configs/ba317k-k16.json").read_text())
    cfg.update(name="dummy-k2", k=2)
    (r / "perfbench/configs/dummy-k2.json").write_text(json.dumps(cfg))
    mix = json.loads((r / "perfbench/traffic/sssp-lanes.json").read_text())
    mix.update(programs=[{"program": "bfs", "weight": 1}], clients=4)
    (r / "perfbench/traffic/bfs-only.json").write_text(json.dumps(mix))
    (r / "perfbench/metrics/dummy_checked.serve.py").write_text(
        "def read(run):\n    return float(run.sizes['checked'])\n")
    spec["configs"].append({"name": "dummy-k2", "source": "a test",
                            "file": "perfbench/configs/dummy-k2.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy-k2.bfs-only",
                              "config": "dummy-k2", "traffic": "bfs-only",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "queries_per_s" == m["name"] or "query_p95_s" == m["name"]:
            m["workloads"].append("dummy-k2.bfs-only")
    spec["per_layer"].append({"name": "dummy_checked.serve", "unit": "1",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "gserve front end",
                              "moves": "queries_per_s",
                              "workloads": ["dummy-k2.bfs-only"]})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.execute(r, "dummy-k2.bfs-only", 5, 0.2, True, "cpu",
                          time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["dummy_checked.serve"]["value"] > 0
    out = harness.execute(r, "dummy-k2.bfs-only", 5, 0.2, False, "cpu",
                          time.perf_counter())
    assert set(out["metrics"]) == {"queries_per_s", "query_p95_s",
                                   "setup_s"}


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "reproducible"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                      "jaxlib.xla"]) == ["flax", "jax",
                                                         "jaxlib", "repro"]


def _python(code: str, cwd=REPO, **env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    full.update(OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=120)


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    """A whole traced CPU run, in a fresh process: every module it loaded,
    harness and program, is held to the forbidden names; the references
    load nothing of the port."""
    code = f"""
import sys, time
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import perfbench.checks, perfbench.control
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch'], \\
    'the references loaded the port'
from pathlib import Path
from perfbench import harness
harness.execute(Path({str(root)!r}), 'ba317k-k16.sssp-lanes', 3, 0.1, True,
                'cpu', time.perf_counter())
print(harness.forbidden_modules())
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
