"""The port's roofline: the counter (``roofline/count.py``), the analysis
(``roofline/analysis.py``), the scan kernels' work counts, and the
renderers (``roofline/report.py``, ``roofline/experiments_md.py``) against
the reference's on the same records, written under ``tmp_path``."""
import csv
import json

import pytest
import torch

from repro.launch import mesh as RM
from repro.roofline import experiments_md as RX
from repro.roofline import report as RR
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS
from repro_torch.roofline import analysis as PA
from repro_torch.roofline import count as C
from repro_torch.roofline import experiments_md as PX
from repro_torch.roofline import report as PR
from repro_torch.sharding import env as PE

# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_convention(device):
    """mm 2·M·N·K, elementwise one a output element, reductions and
    scatters one an input element, copies none; bytes are operands plus
    outputs, views and allocations none; the same on ``meta``."""
    a = torch.ones((4, 8), device=device)
    b = torch.ones((8, 3), device=device)
    with C.Counter(device) as c:
        y = a @ b                              # mm: 2·4·3·8
    assert c.counts.flops == 2 * 4 * 3 * 8 and c.counts.ops == 1
    assert c.counts.bytes == 4 * (32 + 24 + 12)
    with C.Counter(device) as c:
        v = y.view(12)                         # view: nothing
        s = v.sum()                            # reduction: 12
        e = torch.exp(y)                       # pointwise: 12
        z = y.clone()                          # copy: 0 flops, bytes
        torch.empty(5, device=device)          # allocation: nothing
        idx = torch.zeros(2, dtype=torch.long, device=device)
        z.index_add_(0, idx, torch.ones((2, 3), device=device))
    del s, e
    assert c.counts.flops == 12 + 12 + 0 + 12
    assert c.counts.peak_live_bytes > 0 and c.counts.other_device_ops == 0
    assert c.reads(y) and c.reads(z) and not c.reads(a)


def test_kernel_regions_are_opaque_and_counted():
    x = torch.ones(4)
    with C.Counter("cpu") as c:
        with C.kernel("k", (7, 100), reads=(x,)):
            (x * 2).sum()
        with C.kernel("k", (7, 100)):
            pass
    assert c.counts.ops == 0
    assert c.counts.kernels == {"k": {"launches": 2, "flops": 14,
                                      "bytes": 200}}
    assert (c.counts.flops, c.counts.bytes) == (14, 200) and c.reads(x)
    with pytest.raises(RuntimeError), C.Counter("cpu") as c2:
        with C.kernel("k", (1, 1)):
            raise RuntimeError("launch failed")
    assert c2.counts.kernels == {}


def test_counter_leaves_other_devices_apart():
    x = torch.ones(3)
    with C.Counter("meta") as c:
        x + 1
    assert c.counts.ops == 0 and c.counts.other_device_ops == 1


# ---------------------------------------------------------------------------
# The scan kernels' work counts and their bounds
# ---------------------------------------------------------------------------

def _scan_bound_inline(b, s, d, n, h0):
    """chip_smoke.py's selective_scan counts as it wrote them inline."""
    return 6 * b * s * d * n, 4 * (3 * b * s * d + 2 * b * s * n + d * n + d
                                   + b * d * n * (2 if h0 else 1))


def _scan_bwd_bytes_inline(b, s, d, n):
    chunks = -(-s // ops.SCAN_CHUNK)
    return 4 * (5 * b * s * d + 4 * b * s * n + 2 * d * n + 2 * d
                + b * chunks * d * n + 2 * b * d * n)


@pytest.mark.parametrize("shape", [(4, 512, 8192, 16, False),
                                   (4, 1, 8192, 16, True),
                                   (2, 37, 133, 8, True)])
def test_scan_work_counts_equal_the_inline_formulas(shape):
    b, s, d, n, h0 = shape
    assert ops.selective_scan_work(b, s, d, n, h0) == _scan_bound_inline(
        b, s, d, n, h0)
    flops, nbytes = ops.selective_scan_work(b, s, d, n, h0, states=True)
    assert nbytes - _scan_bound_inline(b, s, d, n, h0)[1] == \
        4 * b * -(-s // ops.SCAN_CHUNK) * d * n
    assert ops.selective_scan_bwd_work(b, s, d, n) == (
        18 * b * s * d * n, _scan_bwd_bytes_inline(b, s, d, n))


def test_scan_bounds_at_the_kernel_tables_shapes():
    """PERF.md's rows 7 and 7b: 0.0642 ms (the exps of [4, 512, 8192,
    16] on 132 SMs at 1,980 MHz) and 0.0611 ms (the backward's bytes at
    [2, 512, 8192, 16])."""
    exps = 4 * 512 * 8192 * 16 / (16 * 132 * 1.98e9)
    flops, nbytes = ops.selective_scan_work(4, 512, 8192, 16, False)
    fwd = max(nbytes / PM.HBM_BW, flops / PM.FP32_FLOPS, exps)
    assert round(1e3 * fwd, 4) == 0.0642
    flops, nbytes = ops.selective_scan_bwd_work(2, 512, 8192, 16)
    bwd = max(nbytes / PM.HBM_BW, flops / PM.FP32_FLOPS, exps / 2)
    assert round(1e3 * bwd, 4) == 0.0611 and bwd == nbytes / PM.HBM_BW


# ---------------------------------------------------------------------------
# The analysis
# ---------------------------------------------------------------------------

def _params(arch, shape, mesh):
    with PE.use_mesh(mesh):
        return PS.input_specs(arch, shape)["params"]


def test_collectives_follow_the_stated_rule():
    """None on one chip; a training step gathers every fsdp-split
    parameter twice (a serving step once) and reduce-scatters each
    gradient; a second pod adds an all-reduce over the pods; tp adds the
    activations' all-reduces."""
    cfg = get_config("qwen3-0.6b")
    one = PM.make_mesh((1, 1), ("data", "model"))
    assert sum(PA.collective_bytes(cfg, SHAPES["train_4k"], one,
                                   _params("qwen3-0.6b", "train_4k", one))
               .values()) == 0
    m = PM.make_production_mesh()
    p = _params("qwen3-0.6b", "train_4k", m)
    train = PA.collective_bytes(cfg, SHAPES["train_4k"], m, p)
    serve = PA.collective_bytes(cfg, SHAPES["prefill_32k"], m, p)
    assert train["all-gather"] == 2 * serve["all-gather"] > 0
    assert train["reduce-scatter"] == serve["all-gather"]
    assert serve["reduce-scatter"] == 0
    mp = PM.make_production_mesh(multi_pod=True)
    pod = PA.collective_bytes(cfg, SHAPES["train_4k"], mp,
                              _params("qwen3-0.6b", "train_4k", mp))
    assert pod["all-reduce"] > 0
    no_tp = PM.make_mesh((16, 1), ("data", "model"))
    flat = PA.collective_bytes(cfg, SHAPES["decode_32k"], no_tp,
                               _params("qwen3-0.6b", "decode_32k", no_tp))
    assert flat["all-reduce"] == 0 and flat["all-gather"] > 0


def test_analyze_divides_by_chips_and_the_cards_peaks():
    counts = C.Counts(flops=10 ** 15, bytes=10 ** 13)
    cfg = get_config("qwen3-4b")
    m = PM.make_production_mesh()
    p = _params("qwen3-4b", "prefill_32k", m)
    r = PA.analyze(counts, cfg, SHAPES["prefill_32k"], m, p)
    assert r.flops == 10 ** 15 / 256
    assert r.compute_s == r.flops / PM.PEAK_FLOPS_BF16
    assert r.memory_s == r.bytes_hbm / PM.HBM_BW == 10 ** 13 / 256 / 3.35e12
    coll = PA.collective_bytes(cfg, SHAPES["prefill_32k"], m, p)
    assert r.coll_bytes == sum(coll.values()) > 0
    assert r.collective_s == r.coll_bytes / PM.LINK_BW
    assert r.dominant == max(("compute", r.compute_s), ("memory", r.memory_s),
                             ("collective", r.collective_s),
                             key=lambda kv: kv[1])[0]
    assert r.useful_ratio == (PA.model_flops(cfg, SHAPES["prefill_32k"])
                              / 256) / r.flops
    assert set(r.to_json()) == {
        "flops", "bytes_hbm", "coll_bytes", "compute_s", "memory_s",
        "collective_s", "dominant", "model_flops_global", "useful_ratio",
        "raw_cost_analysis"}


# ---------------------------------------------------------------------------
# The renderers against the reference's
# ---------------------------------------------------------------------------

CELLS = (("falcon-mamba-7b", "long_500k", False),
         ("falcon-mamba-7b", "long_500k", True),
         ("whisper-small", "decode_32k", False),
         ("qwen2-moe-a2.7b", "decode_32k", False),
         ("jamba-v0.1-52b", "long_500k", False),
         ("qwen3-0.6b", "long_500k", False))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Port records of cheap cells, BASELINE and TUNED, plus an error
    record, written as the CLI writes them; each also carries its
    ``count_s`` as ``compile_s`` for the reference's dry-run table."""
    root = tmp_path_factory.mktemp("records")
    for sub, perf in (("dryrun", False), ("perf", True)):
        (root / sub).mkdir()
        for arch, shape, mp in CELLS:
            rec = D.run_cell(arch, shape, mp, perf=perf)
            if "count_s" in rec:
                rec["compile_s"] = rec["count_s"]
            (root / sub / f"{arch}__{shape}__{rec['mesh']}.json").write_text(
                json.dumps(rec))
    (root / "dryrun" / "x__error.json").write_text(json.dumps(
        {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "16x16",
         "status": "error", "error": "boom"}))
    return root


def test_report_tables_render_as_the_reference(records):
    recs = PR.load(str(records / "dryrun"))
    assert recs == RR.load(str(records / "dryrun"))
    for mesh in ("16x16", "2x16x16"):
        assert PR.dryrun_table(recs, mesh) == RR.dryrun_table(
            recs, mesh).replace("compile s", "count s")
    assert PR.roofline_table(recs, peak_flops=RM.PEAK_FLOPS_BF16) == \
        RR.roofline_table(recs)
    assert PR.roofline_table(recs) != RR.roofline_table(recs)
    assert [(r["arch"], r["shape"]) for r in PR.pick_hillclimb(recs)] == \
        [(r["arch"], r["shape"]) for r in RR.pick_hillclimb(recs)]
    for b in (0, 1023, 1024, 5e9, 3e15):
        assert PR.fmt_bytes(b) == RR.fmt_bytes(b)


def _bench_csvs(root):
    bench = root / "experiments" / "bench"
    bench.mkdir(parents=True)
    rows = {
        "fig7_comparison": [
            {"dataset": ds, "algo": al, "largest": 1.1 + i, "nstdev": 0.2,
             "messages": 400 + i, "gain": 0.9, "connected": 1.0,
             "rounds": 30 + i}
            for i, (ds, al) in enumerate([("astroph", "dfep"),
                                          ("astroph", "jabeja"),
                                          ("astroph", "dfep")])],
        "fig5_k_sweep": [
            {"dataset": "usroads", "k": k, "algo": "dfep", "rounds": 10 * k,
             "largest": 1.2, "nstdev": 0.1 * k, "messages": 5 * k,
             "gain": 0.5} for k in (4, 8, 4)],
        "fig6_diameter": [
            {"remap_frac": f, "diameter_proxy": d, "rounds": 3, "largest": 1,
             "nstdev": 0.1, "messages": 9, "gain": 0.4,
             "disconnected_pct": 2.5}
            for f, d in ((0.1, 40), (0.2, 20), (0.1, 40))]}
    for name, rs in rows.items():
        with open(bench / f"{name}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rs[0]))
            w.writeheader()
            w.writerows(rs)


def test_experiments_md_tables_render_as_the_reference(records, tmp_path,
                                                       monkeypatch, capsys):
    _bench_csvs(tmp_path)
    monkeypatch.chdir(tmp_path)
    for fn in ("agg_fig5", "agg_fig6", "agg_fig7"):
        assert getattr(PX, fn)() == getattr(RX, fn)() != []
    rows = PX.agg_fig7()
    cols = ["dataset", "algo", "gain", "rounds"]
    assert PX.md_table(rows, cols) == RX.md_table(rows, cols)
    base = PR.load(str(records / "dryrun"))
    tuned = PR.load(str(records / "perf"))
    assert PX.perf_compare(base, tuned) == RX.perf_compare(base, tuned) != []
    PX.main(["--dir", str(records / "dryrun"),
             "--perf-dir", str(records / "perf")])
    text = capsys.readouterr().out
    assert PR.dryrun_table(base, "16x16") in text
    assert "H100" in text and "meta" in text
    for tpu in ("v5e", "TPU", "197", "819", "ICI"):
        assert tpu not in text


def test_report_main_prints_every_section(records, capsys):
    PR.main(["--dir", str(records / "dryrun")])
    out = capsys.readouterr().out
    for head in ("16x16, 256 chips", "2x16x16, 512 chips", "Roofline",
                 "Hillclimb"):
        assert head in out
    assert "| granite-3-2b | train_4k | ERROR |" in out


def test_dry_run_takes_its_own_shape_and_mesh():
    cfg = get_config("qwen3-0.6b", smoke=True)
    rec = D.run_cell("qwen3-0.6b", "tiny", cfg=cfg,
                     shape=ShapeConfig("tiny", 16, 4, "train"),
                     mesh=PM.make_mesh((2, 2), ("data", "model")))
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["shape"] == "tiny" and rec["status"] == "ok"
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == sum(rec["argument_bytes"].values())
    assert ma["output_size_in_bytes"] > 0 and ma["temp_size_in_bytes"] > 0
