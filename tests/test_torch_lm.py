"""repro_torch's language-model path (configs → falcon-mamba LM → serving)
against the JAX package on the CPU, on the SMOKE config (4 layers, d_model
128) with the JAX init's parameters carried across by
``params_from_reference``. Prompts come from numpy seeds.

Tolerances:
* logits (bfloat16) and caches: max |Δ| ≤ LOGIT_REL · max |ref|. The two
  packages' blocks agree to one bfloat16 ulp (2^-8 ≈ 3.9e-3 relative):
  XLA's and torch's float32 ``exp``/``log1p`` differ in the last bits, and
  JAX's associative scan sums in another order than the port's sequential
  one, so a value near a rounding boundary may round the other way. Four
  residual layers and the head's 128-term dot carry such flips into the
  logits; measured, they stay within one ulp of the largest logit.
* greedy tokens: bfloat16 logits tie often (SMOKE's 512 logits share 256
  values per octave), and a one-ulp difference decides a tie. So the JAX
  loop is fed the port's tokens, and each token the port picks must be
  within the logit bound of that step's JAX maximum: where JAX's top two
  logits are further apart than the bound, the port's token is JAX's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import lm as RL
from repro.serve import serve_step as RSS
from repro_torch import configs as TC
from repro_torch.kernels import ops as TO
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS
from repro_torch.serve import serve_step as TSS

ROOT = Path(__file__).resolve().parents[1]
ARCH = "falcon-mamba-7b"
LOGIT_REL = 1e-2
BATCH, N_NEW = 3, 8
CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params) on SMOKE."""
    cfg = ref_config(ARCH, smoke=True)
    params, _ = RL.init_params(cfg, jax.random.key(0))
    tcfg = TC.get_config(ARCH, smoke=True)
    tparams = TL.params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                       CPU)
    return cfg, params, tcfg, tparams


def _prompts(s: int, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, s)) \
        .astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_to_max(got, want, rel=LOGIT_REL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _caches_close(tc, jc):
    assert set(tc) == set(jc)
    for name in jc:
        assert len(tc[name]) == len(jc[name]) == 2
        for got, want in zip(tc[name], jc[name]):
            assert got.dtype == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32}[str(want.dtype)]
            _close_to_max(got, want)


@pytest.mark.parametrize("s", [8, 3, 32])
def test_forward_lm_matches_reference(model, s):
    cfg, params, tcfg, tparams = model
    toks = _prompts(s, seed=s, vocab=cfg.vocab)
    jl, _, jc = RL.forward_lm(cfg, params, jnp.asarray(toks), remat=False,
                              collect_cache=True)
    tl, aux, tc = TL.forward_lm(tcfg, tparams, torch.from_numpy(toks),
                                collect_cache=True)
    assert tl.dtype == torch.bfloat16
    assert tl.shape == (BATCH, s, TL.vocab_pad(tcfg)) == jl.shape
    assert float(aux) == 0.0
    _close_to_max(tl, jl)
    _caches_close(tc, jc)
    r, d_in = tcfg.block_repeats, TS.ssm_dims(tcfg)[1]
    assert tc["l0"][0].shape == (r, BATCH, tcfg.ssm.d_conv - 1, d_in)
    assert tc["l0"][1].shape == (r, BATCH, d_in, tcfg.ssm.d_state)
    # without collect_cache there are no caches
    assert TL.forward_lm(tcfg, tparams, torch.from_numpy(toks))[2] is None


@pytest.mark.parametrize("s", [8, 3])
def test_decode_step_matches_reference(model, s):
    """Two decode steps from each package's own prefill caches."""
    cfg, params, tcfg, tparams = model
    toks = _prompts(s, seed=10 + s, vocab=cfg.vocab)
    nxt = _prompts(2, seed=20 + s, vocab=cfg.vocab)
    _, jc = RSS.prefill(cfg, params, jnp.asarray(toks))
    _, tc = TSS.prefill(tcfg, tparams, torch.from_numpy(toks))
    for k in range(2):
        jl, jc = RL.decode_step(cfg, params, jnp.asarray(nxt[:, k:k + 1]),
                                jc, jnp.int32(s + k))
        before = {n: tuple(t.clone() for t in c) for n, c in tc.items()}
        tl, new = TL.decode_step(tcfg, tparams,
                                 torch.from_numpy(nxt[:, k:k + 1]), tc, s + k)
        for n in tc:   # the caches passed in are left as they were
            assert all(torch.equal(a, b) for a, b in zip(tc[n], before[n]))
        tc = new
        assert tl.shape == (BATCH, 1, TL.vocab_pad(tcfg))
        _close_to_max(tl, jl)
        _caches_close(tc, jc)


def _reference_logits_along(cfg, params, prompts, tokens) -> np.ndarray:
    """A JAX prefill-plus-decode loop fed ``tokens`` [B, n] (the port's
    choices): each step's logits over the real vocabulary, [B, n, V]."""
    lg, c = RSS.prefill(cfg, params, jnp.asarray(prompts))
    out = [lg[:, -1]]
    s = prompts.shape[1]
    for k in range(tokens.shape[1] - 1):
        lg, c = RSS.decode(cfg, params, jnp.asarray(tokens[:, k:k + 1]), c,
                           jnp.int32(s + k))
        out.append(lg[:, -1])
    return _f32(jnp.stack(out, 1))[..., :cfg.vocab]


@pytest.mark.parametrize("s", [8, 3])
def test_generate_matches_reference_greedy_loop(model, s):
    """Engine.generate's tokens against the JAX loop: at every step the
    port's token is JAX's greedy choice up to the logit bound (see the
    module docstring); where JAX's margin exceeds the bound they are equal.
    At s = 3 = d_conv - 1 the reference's own Engine.generate is not the
    yardstick: its cache growth pads the conv window (ROADMAP §3)."""
    cfg, params, tcfg, tparams = model
    prompts = _prompts(s, seed=30 + s, vocab=cfg.vocab)
    toks = TSS.Engine(tcfg, tparams, s_max=s + N_NEW + 8).generate(
        torch.from_numpy(prompts), N_NEW)
    assert toks.dtype == torch.int32 and toks.shape == (BATCH, N_NEW)
    toks = toks.numpy()
    lj = _reference_logits_along(cfg, params, prompts, toks)
    tol = LOGIT_REL * np.abs(lj).max()
    chosen = np.take_along_axis(lj, toks[..., None].astype(np.int64), -1)
    assert (chosen[..., 0] >= lj.max(-1) - tol).all()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    np.testing.assert_array_equal(toks[clear], lj.argmax(-1)[clear])


@pytest.mark.parametrize("s", [3, 8])
def test_generate_equals_own_prefill_decode_loop(model, s):
    """Engine.generate at s = d_conv - 1 (where the reference's shape test
    would pad the conv window) equals the port's own prefill-plus-decode
    loop, token for token, and decode equals a prefill of the longer
    prompt exactly on the CPU."""
    _, _, tcfg, tparams = model
    prompts = torch.from_numpy(_prompts(s, seed=40 + s, vocab=tcfg.vocab))
    got = TSS.Engine(tcfg, tparams, s_max=s + N_NEW).generate(prompts, N_NEW)
    logits, caches = TSS.prefill(tcfg, tparams, prompts)
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    want, seq = [tok], prompts
    for n in range(s, s + N_NEW - 1):
        logits, caches = TSS.decode(tcfg, tparams, tok, caches, n)
        seq = torch.cat([seq, tok], 1)
        full, _, _ = TL.forward_lm(tcfg, tparams, seq)
        assert torch.equal(full[:, -1:], logits)
        assert caches["l0"][0].shape[2] == tcfg.ssm.d_conv - 1
        tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
        want.append(tok)
    assert torch.equal(got, torch.cat(want, 1))


def test_generate_launches_the_scan_once_per_layer_and_step(model,
                                                            monkeypatch):
    _, _, tcfg, tparams = model
    calls = []
    real = TO.selective_scan
    monkeypatch.setattr(TO, "selective_scan",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    prompts = torch.from_numpy(_prompts(5, seed=1, vocab=tcfg.vocab))
    TSS.Engine(tcfg, tparams, s_max=16).generate(prompts, 4)
    r = tcfg.n_layers
    assert calls == [5] * r + [1] * (3 * r)


def test_generate_rejects_more_tokens_than_s_max(model):
    _, _, tcfg, tparams = model
    prompts = torch.zeros((1, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="s_max"):
        TSS.Engine(tcfg, tparams, s_max=8).generate(prompts, 3)


def test_greedy_token_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 1, 256)).astype(np.float32)
    logits[0, 0, 250] = 99.0        # a padding column never wins
    logits[1, 0, [3, 7]] = 50.0     # ties go to the first index
    want = np.asarray(RSS.greedy_token(jnp.asarray(logits), 200))
    got = TSS.greedy_token(torch.from_numpy(logits), 200)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1, 0]) == 3


def test_grow_caches_pads_only_sequence_axes(model, monkeypatch):
    """Growth is chosen by kind: the SSM caches are kept as they are, and
    a cache kind with a sequence axis is padded along that axis only."""
    _, _, tcfg, _ = model
    conv = torch.ones((4, 2, 3, 8), dtype=torch.bfloat16)
    h = torch.ones((4, 2, 8, 4))
    caches = {"l0": (conv, h)}
    kept = TSS.grow_caches(tcfg, caches, batch=2, s_max=3)
    assert kept["l0"][0] is conv and kept["l0"][1] is h
    monkeypatch.setattr(TL, "cache_struct", lambda cfg, b, s: {
        "l0": ((None, None, 2), (None, None, None))})
    grown = TSS.grow_caches(tcfg, caches, batch=2, s_max=10)
    assert grown["l0"][0].shape == (4, 2, 10, 8)
    assert torch.equal(grown["l0"][0][:, :, :3], conv)
    assert not grown["l0"][0][:, :, 3:].any()
    assert grown["l0"][1] is h


# ---------------------------------------------------------------------------
# parameters and configs
# ---------------------------------------------------------------------------

def test_params_from_reference_round_trip(model):
    cfg, params, tcfg, tparams = model
    ref_np = jax.tree.map(np.asarray, params)
    back = TL.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)
    again = TL.params_from_reference(tcfg, back, CPU)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                 jax.tree.leaves(tparams)))


def test_params_from_reference_checks_every_leaf(model):
    _, params, tcfg, _ = model
    ref_np = jax.tree.map(np.asarray, params)
    bad = jax.tree.map(lambda a: a, ref_np)
    bad["blocks"]["l0"]["mixer"]["x_proj"] = \
        bad["blocks"]["l0"]["mixer"]["x_proj"][:, :, :-1]
    with pytest.raises(ValueError, match="x_proj"):
        TL.params_from_reference(tcfg, bad, CPU)
    missing = jax.tree.map(lambda a: a, ref_np)
    del missing["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        TL.params_from_reference(tcfg, missing, CPU)


def test_init_params_shapes_and_distributions():
    """The port's own init: the reference's shapes and dtypes, its
    constants, and the spread of its random draws."""
    cfg = ref_config(ARCH, smoke=True)
    tcfg = TC.get_config(ARCH, smoke=True)
    ref_params, _ = RL.init_params(cfg, jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    p = TL.init_params(tcfg, gen, CPU)
    assert jax.tree.structure(TL.params_to_numpy(p)) == \
        jax.tree.structure(jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(ref_params)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    m = p["blocks"]["l0"]["mixer"]
    n = tcfg.ssm.d_state
    np.testing.assert_allclose(   # float32 log: last bit per library
        m["a_log"].numpy(),
        np.broadcast_to(np.log(np.arange(1, n + 1, dtype=np.float32)),
                        m["a_log"].shape), rtol=1e-6)
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    assert not m["conv_b"].any()
    step = torch.nn.functional.softplus(m["dt_bias"])
    assert float(step.min()) >= 1e-3 * 0.999 and float(step.max()) <= 0.1001
    dt_rank = TS.ssm_dims(tcfg)[2]
    for name, std in (("in_proj", 0.02), ("conv_w", 0.2),
                      ("dt_proj", dt_rank ** -0.5),
                      ("out_proj", 0.02 / np.sqrt(2 * tcfg.n_layers))):
        assert abs(float(m[name].std()) / std - 1) < 0.1, name
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.05
    # the same generator state gives the same parameters
    again = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                 jax.tree.leaves(p)))


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_reference(smoke):
    cfg = ref_config(ARCH, smoke=smoke)
    tcfg = TC.get_config(ARCH, smoke=smoke)
    assert tcfg.param_count() == cfg.param_count()
    assert tcfg.layer_pattern == cfg.layer_pattern
    assert tcfg.block_repeats == cfg.block_repeats
    if not smoke:
        assert tcfg.param_count() == 7_271_350_272
        assert (tcfg.n_layers, tcfg.d_model, TS.ssm_dims(tcfg)[1:]) == \
            (64, 4096, (8192, 256))
        assert TL.vocab_pad(tcfg) == 65024


def test_param_count_counts_the_matrices_of_init():
    """``param_count`` leaves out the vectors (norms, conv and dt biases);
    every other leaf of ``init_params`` is counted."""
    tcfg = TC.get_config(ARCH, smoke=True)
    p = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    total = sum(t.numel() for t in jax.tree.leaves(p))
    r, d, d_in = tcfg.block_repeats, tcfg.d_model, TS.ssm_dims(tcfg)[1]
    assert total == tcfg.param_count() + r * (d + 2 * d_in) + d


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_get_config_of_unported_architecture_raises(arch, monkeypatch):
    """Every architecture is ported; an id whose module is taken out of
    ``PORTED`` is refused."""
    assert set(TC.PORTED) == set(TC.ARCH_IDS.values())
    monkeypatch.setattr(TC, "PORTED", tuple(
        m for m in TC.PORTED if m != TC.ARCH_IDS[arch]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TC.get_config(arch, smoke=True)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-1.5b", "granite-3-2b",
                                  "qwen3-4b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b", "deepseek-v2-236b",
                                  "whisper-small", "llava-next-34b"])
def test_get_config_of_ported_architecture_matches_reference(arch):
    """The port's CONFIG and SMOKE equal the reference's field for field,
    and so do their parameter counts and layer patterns."""
    import dataclasses
    for smoke in (False, True):
        ref, port = ref_config(arch, smoke=smoke), TC.get_config(arch, smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.layer_pattern == ref.layer_pattern
        assert port.block_repeats == ref.block_repeats


def test_get_config_and_unported_family():
    assert TC.get_config("falcon_mamba_7b").name == "falcon-mamba-7b"
    with pytest.raises(KeyError):
        TC.get_config("no-such-model")
    # every family is ported; encdec has an encoder and a cross block on
    # each decoder layer, vlm neither
    assert set(TL.PORTED_FAMILIES) == {"ssm", "hybrid", "dense", "moe",
                                       "encdec", "vlm"}
    for family in ("encdec", "vlm"):
        cfg = TC.ModelConfig(name=family, family=family, n_layers=2,
                             d_model=64, n_heads=4, n_kv=4, d_ff=128,
                             vocab=256, n_enc_layers=3 * (family == "encdec"))
        shapes = TL.param_shapes(cfg)
        cross = family == "encdec"
        assert ("enc_blocks" in shapes) == cross
        assert ("cross" in shapes["blocks"]["l0"]) == cross
        if cross:
            assert shapes["enc_blocks"]["l0"]["norm1"] == (3, 64)
            assert shapes["blocks"]["l0"]["cross"]["wq"] == (2, 64, 4, 16)
    # the hybrid family and MLA attention are ported
    hybrid = TC.get_config("jamba-v0.1-52b", smoke=True)
    assert "hybrid" in TL.PORTED_FAMILIES
    assert set(TL.param_shapes(hybrid)["blocks"]) == {"l0", "l1", "l2", "l3"}
    mla = TC.ModelConfig(name="mla", family="moe", n_layers=2, d_model=64,
                         n_heads=4, n_kv=4, d_ff=128, vocab=256,
                         mla=TC.MlaConfig(kv_lora=32),
                         moe=TC.MoeConfig(n_experts=4, top_k=2))
    assert TL.param_shapes(mla)["blocks"]["l0"]["mixer"]["w_dkv"] == \
        (2, 64, 32)


def test_launch_serve_prints_one_line_per_request():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "6",
         "--n-new", "4"], capture_output=True, text=True, env=env,
        timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3
    for i, line in enumerate(lines):
        head, toks = line.split(": ", 1)
        assert head == f"req {i}"
        toks = json.loads(toks)
        assert len(toks) == 4 and all(0 <= t < 512 for t in toks)
