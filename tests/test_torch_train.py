"""repro_torch's training substrate against the JAX package on the CPU:
AdamW, its schedule, clipping and ``global_norm``; the int8 gradient
codec with error feedback; checkpoints in the reference's format, written
by each package and restored by the other; the ``Trainer``'s resume; and
``python -m repro_torch.launch.train``. Inputs come from numpy seeds.

Tolerances:
* AdamW, the schedule, the norm (float32): relative 1e-6 of each leaf's
  largest |value| (the same elementwise arithmetic; XLA's and torch's
  ``cos``, ``pow`` and ``sqrt`` may differ in the last bit, and XLA may
  contract a multiply-add);
* the codec and checkpoints: bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as RC
from repro.train import compress as RZ
from repro.train import optimizer as RO
from repro_torch import configs as TC
from repro_torch.ckpt import checkpoint as TCk
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import lm as TL
from repro_torch.train import compress as TZ
from repro_torch.train import optimizer as TO
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train_families import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
REL = 1e-6


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "blocks": {"a": (scale * rng.standard_normal(33))
                       .astype(np.float32),
                       "b": (scale * rng.standard_normal((3, 2, 4)))
                       .astype(np.float32)}}


def _t(tree):
    return TO.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rel=REL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _close_trees(got, want, rel=REL):
    g, w = TO.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, rel)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10_000, 12_000])
def test_schedule_matches_reference(step):
    cfg = TO.AdamWConfig()
    rcfg = RO.AdamWConfig()
    got = TO.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = RO.schedule(rcfg, jnp.int32(step))
    assert got.dtype == torch.float32
    _close(got, want)


def test_global_norm_sums_leaves_in_sorted_key_order():
    tree = _tree(1)
    got, want = TO.global_norm(_t(tree)), RO.global_norm(_j(tree))
    assert float(got) == float(want)
    assert [t.shape for t in TO.tree_leaves(_t(tree))] == \
        [t.shape for t in jax.tree.leaves(_j(tree))]


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_apply_updates_matches_reference_over_steps(clip):
    """Three AdamW steps from the same parameters on the same gradients,
    with and without clipping: parameters, moments, step and metrics."""
    kw = dict(grad_clip=clip, warmup_steps=2, total_steps=10)
    cfg, rcfg = TO.AdamWConfig(**kw), RO.AdamWConfig(**kw)
    p, rp = _t(_tree(2)), _j(_tree(2))
    st, rst = TO.init_opt_state(p), RO.init_opt_state(rp)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for i in range(3):
        g = _tree(10 + i, scale=0.1 * (i + 1))
        p, st, m = TO.apply_updates(cfg, p, _t(g), st)
        rp, rst, rm = RO.apply_updates(rcfg, rp, _j(g), rst)
        _close_trees(p, rp)
        _close_trees(st.m, rst.m)
        _close_trees(st.v, rst.v)
        assert int(st.step) == int(rst.step) == i + 1
        for k in ("grad_norm", "lr"):
            _close(m[k], rm[k])


def test_apply_updates_leaves_inputs_and_slices_exactly(monkeypatch):
    """The inputs are left as they were, and updating a leaf in slices
    gives the bits of updating it whole."""
    cfg = TO.AdamWConfig(warmup_steps=1)
    p, g = _t(_tree(3)), _t(_tree(4))
    st = TO.init_opt_state(p)
    before = [t.clone() for t in TO.tree_leaves(p)]
    whole = TO.apply_updates(cfg, p, g, st)
    monkeypatch.setattr(TO, "UPDATE_SLICE", 8)
    sliced = TO.apply_updates(cfg, p, g, st)
    for a, b in zip(before, TO.tree_leaves(p)):
        assert torch.equal(a, b)
    assert all(int(t.count_nonzero()) == 0 for t in TO.tree_leaves(st.m))
    for a, b in zip(TO.tree_leaves({"p": whole[0], "m": whole[1].m,
                                    "v": whole[1].v}),
                    TO.tree_leaves({"p": sliced[0], "m": sliced[1].m,
                                    "v": sliced[1].v})):
        assert torch.equal(a, b)


def test_grad_clip_and_hand_computed_step():
    """The reference's two hand checks: a clipped update reports the
    unclipped norm, and step 1 moves by lr·g/(|g| + eps)."""
    cfg = TO.AdamWConfig(lr=1.0, grad_clip=0.001, weight_decay=0.0,
                         warmup_steps=0, total_steps=10**9)
    p = {"w": torch.ones(4)}
    _, _, m = TO.apply_updates(cfg, p, {"w": torch.full((4,), 100.0)},
                               TO.init_opt_state(p))
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    cfg = TO.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                         weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
                         total_steps=10**9)
    p = {"w": torch.tensor([2.0])}
    new_p, _, _ = TO.apply_updates(cfg, p, {"w": torch.tensor([0.5])},
                                   TO.init_opt_state(p))
    assert float(new_p["w"][0]) == pytest.approx(1.9, rel=1e-5)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4099])
def test_compress_matches_reference_bit_for_bit(n):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(np.float32)
    x[::7] = 0.0
    c, rc = TZ.compress(torch.from_numpy(x)), RZ.compress(jnp.asarray(x))
    assert c.q.dtype == torch.int8
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
    np.testing.assert_array_equal(c.scale.numpy(), np.asarray(rc.scale))
    d = TZ.decompress(c, (n,))
    np.testing.assert_array_equal(d.numpy(), np.asarray(
        RZ.decompress(rc, (n,))))
    assert float((d - torch.from_numpy(x)).abs().max()) \
        <= float(np.abs(x).max()) / 127.0 + 1e-6


def test_round_half_to_even_like_jnp():
    """Values exactly half-way between two int8 steps (a block whose max
    is 127 makes the scale 1) round to even in both packages."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    np.testing.assert_array_equal(TZ.compress(torch.from_numpy(x)).q.numpy(),
                                  np.asarray(RZ.compress(jnp.asarray(x)).q))


def test_ef_compress_tree_matches_reference_over_steps():
    g = _tree(5, scale=0.01)
    err, rerr = TZ.init_error_state(_t(g)), RZ.init_error_state(_j(g))
    for _ in range(4):
        d, err, payload = TZ.ef_compress_tree(_t(g), err)
        rd, rerr, rpayload = RZ.ef_compress_tree(_j(g), rerr)
        for a, b in zip(TO.tree_leaves(d), jax.tree.leaves(rd)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(TO.tree_leaves(err), jax.tree.leaves(rerr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert isinstance(payload["w"], TZ.Compressed)
        np.testing.assert_array_equal(payload["w"].q.numpy(),
                                      np.asarray(rpayload["w"].q))
    assert TZ.compression_ratio(_t(g)) == RZ.compression_ratio(_j(g))


def _ckpt_trees(seed: int):
    """The same tree in both packages: float32, bfloat16 and int32
    leaves, nested dicts, a tuple, and an ``OptState``."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16 = rng.standard_normal(6).astype(np.float32).astype(ml_dtypes.bfloat16)
    ints = rng.integers(-9, 9, (4,)).astype(np.int32)
    m, v = (rng.standard_normal(5).astype(np.float32) for _ in range(2))
    ref = {"params": {"w": jnp.asarray(f32), "b": {"h": jnp.asarray(bf16)}},
           "t": (jnp.asarray(ints), jnp.asarray(f32[0])),
           "opt": RO.OptState(jnp.int32(7), {"x": jnp.asarray(m)},
                              {"x": jnp.asarray(v)})}
    port = {"params": {"w": torch.from_numpy(f32),
                       "b": {"h": torch.from_numpy(bf16.view(np.int16))
                             .view(torch.bfloat16)}},
            "t": (torch.from_numpy(ints), torch.from_numpy(f32[0].copy())),
            "opt": TO.OptState(torch.tensor(7, dtype=torch.int32),
                               {"x": torch.from_numpy(m)},
                               {"x": torch.from_numpy(v)})}
    return ref, port


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bits(port, ref):
    p = TCk._flatten(port)
    r = RC._flatten(ref)
    assert list(p) == list(r)
    for k in r:
        a, b = _bits(p[k]), _bits(r[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoints_cross_restore_bit_for_bit(tmp_path, async_write):
    ref, port = _ckpt_trees(6)
    writer = TCk.CheckpointManager(str(tmp_path / "port"),
                                   async_write=async_write)
    writer.save(3, port)
    RC.CheckpointManager(str(tmp_path / "ref"), async_write=False) \
        .save(3, ref, blocking=True)
    writer.wait()
    # the same manifest and files from both packages
    for name in ("port", "ref"):
        base = tmp_path / name / "step-000000003"
        man = json.loads((base / "manifest.json").read_text())
        assert man["step"] == 3
        assert man["leaves"]["params/b/h"]["dtype"] == "bfloat16"
        assert man["leaves"]["opt/0"]["dtype"] == "int32"
    a = json.loads((tmp_path / "port/step-000000003/manifest.json")
                   .read_text())["leaves"]
    b = json.loads((tmp_path / "ref/step-000000003/manifest.json")
                   .read_text())["leaves"]
    assert a == b
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            ref)
    # the reference restores the port's checkpoint, the port the reference's
    _assert_bits(port, RC.CheckpointManager(str(tmp_path / "port"))
                 .restore(template))
    got = TCk.CheckpointManager(str(tmp_path / "ref")).restore(port,
                                                               device=CPU)
    assert isinstance(got["opt"], TO.OptState) and isinstance(got["t"],
                                                              tuple)
    assert got["opt"].step.shape == () and got["opt"].step.dtype == \
        torch.int32
    assert got["params"]["b"]["h"].dtype == torch.bfloat16
    _assert_bits(got, ref)


def test_checkpoint_keeps_the_latest_and_checks_shapes(tmp_path):
    _, port = _ckpt_trees(7)
    mgr = TCk.CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (10, 20, 30):
        mgr.save(s, port)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    wrong = dict(port, t=(torch.zeros(5, dtype=torch.int32), port["t"][1]))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(wrong, device=CPU)
    with pytest.raises(FileNotFoundError):
        TCk.CheckpointManager(str(tmp_path / "empty")).restore(port,
                                                               device=CPU)


def test_save_copies_the_snapshot_before_writing(tmp_path):
    """A tensor changed after ``save`` returns does not reach the file."""
    mgr = TCk.CheckpointManager(str(tmp_path))
    tree = {"w": torch.zeros(1000)}
    mgr.save(1, tree)
    tree["w"].fill_(1.0)
    mgr.wait()
    assert float(mgr.restore({"w": torch.zeros(1000)}, device=CPU)["w"]
                 .abs().max()) == 0.0


def test_opt_state_carries_across_both_ways():
    cfg = TC.get_config("qwen3-0.6b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    st = TO.init_opt_state(params)
    st = TO.OptState(st.step + 4, TO.tree_map(lambda t: t + 1.5, st.m),
                     TO.tree_map(lambda t: t + 2.5, st.v))
    back = TL.opt_state_from_reference(cfg, TL.opt_state_to_numpy(st), CPU)
    assert back.step.dtype == torch.int32 and int(back.step) == 4
    for a, b in zip(TO.tree_leaves({"m": st.m, "v": st.v}),
                    TO.tree_leaves({"m": back.m, "v": back.v})):
        assert torch.equal(a, b)


def test_checkpoint_resume_trainer(tmp_path):
    """The reference's scenario: 4 steps with a checkpoint every 2, then a
    new Trainer resumes at step 4 and runs to 6."""
    cfg = TC.get_config("qwen3-0.6b", smoke=True)
    ocfg = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    dcfg = DataConfig(batch=2, seq_len=16)
    t1 = Trainer(cfg, ocfg, dcfg, TrainerConfig(
        steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100),
        device=CPU)
    out = t1.run()
    assert t1.ckpt.latest_step() == 4 and t1.ckpt.all_steps() == [2, 4]
    assert len(out["losses"]) == len(out["step_s"]) == 4
    t2 = Trainer(cfg, ocfg, dcfg, TrainerConfig(
        steps=6, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100),
        device=CPU)
    assert t2.step == 4
    for a, b in zip(TO.tree_leaves({"p": t1.params, "m": t1.opt_state.m}),
                    TO.tree_leaves({"p": t2.params, "m": t2.opt_state.m})):
        assert torch.equal(a, b)
    t2.run()
    assert int(t2.opt_state.step) == 6 and t2.ckpt.latest_step() == 6


def test_trainer_resumes_from_a_reference_checkpoint(tmp_path):
    """A checkpoint the JAX package's Trainer wrote, resumed by the
    port's: the same parameters and optimizer state bit for bit."""
    from repro.configs import get_config as ref_config
    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.train.trainer import Trainer as RTrainer
    from repro.train.trainer import TrainerConfig as RTrainerConfig

    rcfg = ref_config("falcon-mamba-7b", smoke=True)
    rt = RTrainer(rcfg, RO.AdamWConfig(warmup_steps=1),
                  RDataConfig(batch=2, seq_len=8),
                  RTrainerConfig(steps=1, ckpt_dir=str(tmp_path),
                                 ckpt_every=1, log_every=100))
    rt.run()
    cfg = TC.get_config("falcon-mamba-7b", smoke=True)
    t = Trainer(cfg, TO.AdamWConfig(warmup_steps=1), DataConfig(2, 8),
                TrainerConfig(steps=2, ckpt_dir=str(tmp_path), ckpt_every=1,
                              log_every=100), device=CPU)
    assert t.step == 1
    want = TL.params_from_reference(cfg, jax.tree.map(np.asarray, rt.params),
                                    CPU)
    for a, b in zip(TO.tree_leaves(t.params), TO.tree_leaves(want)):
        assert torch.equal(a, b)
    want_opt = TL.opt_state_from_reference(
        cfg, jax.tree.map(np.asarray, rt.opt_state), CPU)
    assert int(t.opt_state.step) == 1
    for a, b in zip(TO.tree_leaves({"m": t.opt_state.m,
                                    "v": t.opt_state.v}),
                    TO.tree_leaves({"m": want_opt.m, "v": want_opt.v})):
        assert torch.equal(a, b)


def test_launch_train_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "falcon-mamba-7b", "--smoke", "--device", "cpu", "--steps", "5",
           "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert "step 5: loss=" in out and "done; checkpoint" in out
    assert (tmp_path / "step-000000005" / "manifest.json").exists()
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300, check=True).stdout
    assert "resumed from step 5" in again
