"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``,
``roofline/count.py``) against the reference's, on the CPU.

* Argument bytes: on a 2×4 mesh for the four cells of
  ``tests/test_dryrun_small.py``, and on 2×2×2 for qwen3-0.6b × train_4k,
  the port's per-device argument bytes equal the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` exactly. The reference runs
  in one subprocess with 8 host devices; its production mesh is replaced
  there by one of Auto axes (JAX's ``make_mesh`` makes Explicit axes,
  which its sharding constraints refuse), and nothing in ``src/repro``
  changes.
* Counts: for every architecture's SMOKE config, the ``meta`` count of a
  prefill (the forward), a train step and a decode step equals the
  counter's tally of the same step on real CPU tensors, the kernels priced
  by their ``*_work`` counts on both sides; the plain scan versions never
  run on ``meta``.
* ``model_flops`` and ``skip_reason`` against the reference's for every
  arch × shape; the serving knobs against the reference's input specs;
  the CLI's records, cache and skips.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import specs as RS
from repro.models import perf as RP
from repro.roofline import analysis as RA
from repro.sharding import env as RE
from repro_torch.configs import SHAPES, ShapeConfig, all_archs, get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS
from repro_torch.models import lm, ssm
from repro_torch.models import perf as PP
from repro_torch.roofline import analysis as PA
from repro_torch.sharding import env as PE
from repro_torch.train.optimizer import OptState, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
ARG_CELLS = (("qwen3-0.6b", "train_4k", False),
             ("qwen2-moe-a2.7b", "decode_32k", False),
             ("whisper-small", "decode_32k", False),
             ("falcon-mamba-7b", "long_500k", False),
             ("qwen3-0.6b", "train_4k", True))
SMALL_MESHES = {False: ((2, 4), ("data", "model")),
                True: ((2, 2, 2), ("pod", "data", "model"))}

REF_SCRIPT = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.launch import dryrun
    from repro.launch import mesh as M
    auto = jax.sharding.AxisType.Auto
    M.make_production_mesh = lambda multi_pod=False: (
        jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                      axis_types=(auto,) * 3) if multi_pod
        else jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2))
    out = {}
    for arch, shape, mp in CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=mp)
        out[f"{arch}|{shape}|{mp}"] = [
            rec["status"], rec.get("error"),
            rec.get("memory_analysis", {}).get("argument_size_in_bytes")]
    print("REF_ARGS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_argument_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT.replace("CELLS", repr(ARG_CELLS))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT,
        start_new_session=True)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("REF_ARGS")]
    assert line, f"stdout:\n{res.stdout[-2000:]}\nstderr:\n{res.stderr[-3000:]}"
    return json.loads(line[0].removeprefix("REF_ARGS "))


@pytest.mark.parametrize("arch,shape,multi_pod", ARG_CELLS)
def test_argument_bytes_equal_reference_compiled(ref_argument_bytes, arch,
                                                 shape, multi_pod):
    status, err, want = ref_argument_bytes[f"{arch}|{shape}|{multi_pod}"]
    assert status == "ok", err
    rec = D.run_cell(arch, shape, mesh=PE.Mesh(*SMALL_MESHES[multi_pod]))
    assert rec["status"] == "ok"
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["mesh"] == ("2x2x2" if multi_pod else "2x4")
    assert rec["roofline"]["flops"] > 0


def _real_like(tree, gen):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return (torch.randn(tree.shape, generator=gen) * 0.02).to(
                tree.dtype)
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _real_like(v, gen) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(_real_like(t, gen) for t in tree))
    return tuple(_real_like(t, gen) for t in tree)


def _smoke_shape(cfg, kind):
    img = cfg.n_img_tokens if cfg.family == "vlm" and kind != "decode" else 0
    return ShapeConfig(kind, 8 + img, 2, kind)


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", all_archs())
def test_meta_count_equals_real_cpu_count(arch, kind):
    """The dry run's count on ``meta`` stand-ins equals the counter's tally
    of the same step on real CPU tensors (random weights, the real run
    decoding at another position): FLOPs, bytes, ops and kernel launches,
    and every argument read on both sides."""
    cfg = get_config(arch, smoke=True)
    shape = _smoke_shape(cfg, kind)
    spec = PS.input_specs(arch, kind, cfg=cfg, shape=shape)
    meta, _, _ = D.count_step(cfg, shape, D.step_inputs(spec), "meta")
    gen = torch.Generator().manual_seed(0)
    real = _real_like(D.step_inputs(spec), gen)
    real["params"] = lm.init_params(cfg, gen, "cpu")
    if "opt" in real:
        real["opt"] = init_opt_state(real["params"])
    cpu, _, _ = D.count_step(cfg, shape, real, "cpu", cache_len=3)
    a, b = meta.counts, cpu.counts
    assert (a.flops, a.bytes, a.ops, a.launches()) == (
        b.flops, b.bytes, b.ops, b.launches())
    assert a.flops > 0 and a.bytes > 0 and a.other_device_ops == 0
    ssm_layers = cfg.n_layers if cfg.family == "ssm" else (
        cfg.block_repeats * cfg.layer_pattern.count("ssm"))
    want = {"selective_scan": (2 if kind == "train" else 1) * ssm_layers,
            "selective_scan_bwd": ssm_layers if kind == "train" else 0}
    assert {k: a.launches().get(k, 0) for k in want} == {
        k: v for k, v in want.items()}
    args = D.argument_bytes({**spec, "cfg": cfg}, meta)
    from torch.utils._pytree import tree_flatten
    for name, tree in real.items():
        leaves = [t for t in tree_flatten(tree)[0]
                  if isinstance(t, torch.Tensor) and cpu.reads(t)]
        assert args[name] == sum(t.numel() * t.element_size()
                                 for t in leaves), name


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_dry_run_never_runs_the_plain_scan(arch, monkeypatch):
    """On ``meta`` the scan's wrappers return empty outputs of the card
    path's shapes and count one launch each; their plain versions are
    never called."""
    def refuse(*a, **k):
        raise AssertionError("a plain scan ran under the dry run")
    for name in ("selective_scan_ref", "selective_scan_fwd_ref",
                 "selective_scan_bwd_ref"):
        monkeypatch.setattr(ref, name, refuse)
    cfg = get_config(arch, smoke=True)
    mesh = PM.make_mesh((1, 1), ("data", "model"))
    _, d_in, _ = ssm.ssm_dims(cfg)
    n, layers = cfg.ssm.d_state, cfg.block_repeats * cfg.layer_pattern.count(
        "ssm")
    for kind in ("train", "prefill", "decode"):
        rec = D.run_cell(arch, kind, cfg=cfg, shape=ShapeConfig(
            kind, 32, 2, kind), mesh=mesh)
        kernels = rec["roofline"]["raw_cost_analysis"]["kernels"]
        s = 1 if kind == "decode" else 32
        fwd = ops.selective_scan_work(2, s, d_in, n, kind == "decode",
                                      kind == "train")
        calls = 2 * layers if kind == "train" else layers
        assert kernels["selective_scan"] == {
            "launches": calls, "flops": calls * fwd[0],
            "bytes": calls * fwd[1]}
        if kind == "train":
            bwd = ops.selective_scan_bwd_work(2, s, d_in, n)
            assert kernels["selective_scan_bwd"] == {
                "launches": layers, "flops": layers * bwd[0],
                "bytes": layers * bwd[1]}
    x = torch.empty((2, 40, 8), device="meta")
    a = torch.empty((8, 4), device="meta")
    bc = torch.empty((2, 40, 4), device="meta")
    d = torch.empty(8, device="meta")
    y, h, hc = ops._scan_forward(x, x, bc, bc, a, d, None, True)
    assert (y.shape, h.shape, hc.shape) == ((2, 40, 8), (2, 8, 4),
                                            (2, 3, 8, 4))
    grads = ops.selective_scan_bwd(x, x, bc, bc, a, d, hc, x, None)
    assert [tuple(g.shape) for g in grads] == [
        (2, 40, 8), (2, 40, 8), (2, 40, 4), (2, 40, 4), (8, 4), (8,),
        (2, 8, 4)]
    assert all(g.device.type == "meta" for g in grads)


@pytest.mark.parametrize("arch", all_archs())
def test_model_flops_and_skip_reason_equal_reference(arch):
    for name, shape in SHAPES.items():
        rcfg, rshape = ref_config(arch), REF_SHAPES[name]
        assert PA.model_flops(get_config(arch), shape) == RA.model_flops(
            rcfg, rshape)
        assert (PS.skip_reason(get_config(arch), shape) is None) == (
            RS.skip_reason(rcfg, rshape) is None)


def _flat(structs, specs, path=""):
    if isinstance(structs, dict):
        out = {}
        for k in structs:
            out.update(_flat(structs[k], specs[k], f"{path}/{k}"))
        return out
    dt = getattr(structs, "dtype")
    return {path: (str(dt).removeprefix("torch."), tuple(specs))}


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "decode_32k"),
                                        ("jamba-v0.1-52b", "long_500k"),
                                        ("whisper-small", "prefill_32k"),
                                        ("qwen3-0.6b", "train_4k")])
@pytest.mark.parametrize("tuned", [False, True])
def test_serving_knobs_equal_reference_input_specs(arch, shape, tuned):
    """Under TUNED a serving cell's parameters are bfloat16 and, where the
    batch is below dp and the tp-split weights fit, not split over fsdp;
    the parameters' dtypes and specs equal the reference's ``input_specs``
    on the 2×4 mesh."""
    m = SMALL_MESHES[False]
    RP.set_perf(RP.TUNED if tuned else RP.BASELINE)
    try:
        with RE.use_mesh(__import__("jax").sharding.AbstractMesh(*m)):
            want = _flat(*RS.input_specs(arch, shape)["params"])
    finally:
        RP.set_perf(RP.BASELINE)
    PP.set_perf(PP.TUNED if tuned else PP.BASELINE)
    try:
        with PE.use_mesh(PE.Mesh(*m)):
            got = _flat(*PS.input_specs(arch, shape)["params"])
    finally:
        PP.set_perf(PP.BASELINE)
    assert got == want


def test_cli_writes_caches_and_skips(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dryrun"
    argv = ["--arch", "falcon-mamba-7b", "--shape", "long_500k", "--out",
            str(out)]
    D.main(argv)
    rec = json.loads((out / "falcon-mamba-7b__long_500k__16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes",
                                           "output_size_in_bytes",
                                           "temp_size_in_bytes"}
    assert "count_s" in rec and "compile_s" not in rec
    assert set(rec["roofline"]) == set(RA.Roofline.__dataclass_fields__)
    D.main(argv)
    assert "cached, skipping" in capsys.readouterr().out
    D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--both-meshes",
            "--out", str(out)])
    for m in ("16x16", "2x16x16"):
        skipped = json.loads((out / f"qwen3-0.6b__long_500k__{m}.json")
                             .read_text())
        assert skipped["status"] == "skipped" and skipped["reason"]

    def boom(*a, **k):
        raise RuntimeError("no meta kernel")
    monkeypatch.setattr(D, "run_cell", boom)
    D.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--out", str(out)])
    err = json.loads((out / "qwen3-4b__decode_32k__16x16.json").read_text())
    assert err["status"] == "error" and "no meta kernel" in err["traceback"]
    monkeypatch.undo()
    D.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--out", str(out)])
    again = json.loads((out / "qwen3-4b__decode_32k__16x16.json").read_text())
    assert again["status"] == "ok"


def test_run_cell_restores_the_threads_profile():
    PP.set_perf(PP.TUNED)
    try:
        D.run_cell("falcon-mamba-7b", "long_500k")
        assert PP.get_perf() is PP.TUNED
    finally:
        PP.set_perf(PP.BASELINE)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_launch_serve_perf_serves_under_tuned(arch, capsys):
    """``launch.serve --perf`` sets the TUNED profile, as the JAX launcher
    does, and serves one line a request under it."""
    from repro_torch.launch import serve
    try:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "5", "--n-new", "3", "--perf"])
        assert PP.get_perf() is PP.TUNED
    finally:
        PP.set_perf(PP.BASELINE)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["req 0", "req 1"]
    assert all(len(json.loads(ln.split(": ", 1)[1])) == 3 for ln in lines)
