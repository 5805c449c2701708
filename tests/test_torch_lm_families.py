"""repro_torch's ``dense``, ``moe`` and ``hybrid`` language-model families
(qwen3-0.6b, qwen2-1.5b, granite-3-2b, qwen3-4b, qwen2-moe-a2.7b,
deepseek-v2-236b with MLA, jamba-v0.1-52b) against the JAX package on the
CPU, each on its SMOKE config with the JAX init's
parameters carried across by ``params_from_reference``: ``forward_lm``
(logits, caches, the MoE ``aux``), ``decode_step``, greedy
``Engine.generate``, the cache layout, the parameters and the launcher.
Prompts come from numpy seeds.

The JAX functions run op by op (``jax.disable_jit``). Compiled, the
reference's own forward differs from its op-by-op run by up to 4% of the
largest logit on qwen2-moe SMOKE (XLA's fusions skip some of the bfloat16
roundings the code writes, and a router then picks another expert for a
token); the dense families are also held against the compiled forward.

Tolerances (the ``LOGIT_REL`` rule of ``tests/test_torch_lm.py``):
* logits and caches (bfloat16): max |Δ| ≤ LOGIT_REL · max |ref|. One bf16
  ulp is 2^-8 ≈ 3.9e-3 relative; XLA's and torch's float32 ``exp``, ``sin``
  and ``cos`` differ in the last bit and their float32 dots sum in other
  orders, so a value near a rounding boundary rounds the other way, and
  four residual layers carry such flips into the logits;
* ``aux`` (float32): relative 1e-5;
* greedy tokens: the JAX loop is fed the port's tokens, and each must be
  within the logit bound of that step's JAX maximum; where JAX's top two
  logits are further apart than the bound, the port's token is JAX's;
* decode against the port's own prefill of one more token: LOGIT_REL, on
  the sequences none of whose tokens the MoE dropped in either run (a
  token's capacity slot is its rank among all tokens routed to the same
  expert, so a longer prefill drops other tokens).
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
from repro_torch.models import layers as TLy
from repro_torch.models import lm as TL
from repro_torch.serve import serve_step as TSS

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "qwen2-1.5b", "granite-3-2b", "qwen3-4b",
         "qwen2-moe-a2.7b", "deepseek-v2-236b", "jamba-v0.1-52b"]
DENSE = ["qwen3-0.6b", "qwen2-1.5b", "granite-3-2b", "qwen3-4b"]
LOGIT_REL = 1e-2
BATCH, N_NEW = 3, 6
CPU = "cpu"

_MODELS: dict = {}


def _model(arch):
    """(JAX cfg, JAX params, port cfg, port params) on SMOKE, built once a
    module."""
    if arch not in _MODELS:
        cfg = ref_config(arch, smoke=True)
        params, _ = RL.init_params(cfg, jax.random.key(0))
        tcfg = TC.get_config(arch, smoke=True)
        tparams = TL.params_from_reference(
            tcfg, jax.tree.map(np.asarray, params), CPU)
        _MODELS[arch] = (cfg, params, tcfg, tparams)
    return _MODELS[arch]


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


def _grow(tcfg, caches, s_max):
    """The reference's caches padded to ``s_max`` along the sequence axis
    of each cache kind (``cache_struct``'s: attention's and MLA's; an SSM
    state has none). The reference's ``Engine.generate`` picks caches by
    shape instead, which pads jamba's conv window at a 3-token prompt."""
    struct = TL.cache_struct(tcfg, 1, s_max)
    out = {}
    for name, tensors in caches.items():
        grown = []
        for x, (_, _, axis) in zip(tensors, struct[name]):
            if axis is not None:
                widths = [(0, 0)] * x.ndim
                widths[axis] = (0, s_max - x.shape[axis])
                x = jnp.pad(x, widths)
            grown.append(x)
        out[name] = tuple(grown)
    return out


def _seq_axis(tcfg, name: str, i: int):
    return TL.cache_struct(tcfg, 1, 1)[name][i][2]


@pytest.mark.parametrize("s", [8, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_matches_reference(arch, s):
    cfg, params, tcfg, tparams = _model(arch)
    toks = _prompts(s, seed=s, vocab=cfg.vocab)
    with jax.disable_jit():
        jl, jaux, jc = RL.forward_lm(cfg, params, jnp.asarray(toks),
                                     remat=False, collect_cache=True)
    tl, aux, tc = TL.forward_lm(tcfg, tparams, torch.from_numpy(toks),
                                collect_cache=True)
    assert tl.dtype == torch.bfloat16
    assert tl.shape == (BATCH, s, TL.vocab_pad(tcfg)) == jl.shape
    _close_to_max(tl, jl)
    assert aux.dtype == torch.float32
    if tcfg.moe is None:
        assert float(aux) == float(jaux) == 0.0
    else:
        assert float(aux) > 0
        assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)
    assert set(tc) == set(jc)
    for name in jc:
        for got, want in zip(tc[name], jc[name]):
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            _close_to_max(got, want)
    # without collect_cache there are no caches
    assert TL.forward_lm(tcfg, tparams, torch.from_numpy(toks))[2] is None


@pytest.mark.parametrize("arch", DENSE)
def test_forward_lm_within_the_compiled_reference(arch):
    cfg, params, tcfg, tparams = _model(arch)
    toks = _prompts(16, seed=0, vocab=cfg.vocab)
    jl, _, _ = RL.forward_lm(cfg, params, jnp.asarray(toks), remat=False)
    tl, _, _ = TL.forward_lm(tcfg, tparams, torch.from_numpy(toks))
    _close_to_max(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """Two decode steps from each package's own prefill caches, grown to
    s_max: logits and the caches written."""
    cfg, params, tcfg, tparams = _model(arch)
    s, s_max = 8, 12
    toks = _prompts(s, seed=10, vocab=cfg.vocab)
    nxt = _prompts(2, seed=20, vocab=cfg.vocab)
    with jax.disable_jit():
        _, jc = RSS.prefill(cfg, params, jnp.asarray(toks))
    jc = _grow(tcfg, jc, s_max)
    _, tc = TSS.prefill(tcfg, tparams, torch.from_numpy(toks))
    tc = TSS.grow_caches(tcfg, tc, BATCH, s_max)
    for k in range(2):
        with jax.disable_jit():
            jl, jc = RL.decode_step(cfg, params,
                                    jnp.asarray(nxt[:, k:k + 1]), jc,
                                    jnp.int32(s + k))
        before = {n: tuple(t.clone() for t in c) for n, c in tc.items()}
        tl, new = TL.decode_step(tcfg, tparams,
                                 torch.from_numpy(nxt[:, k:k + 1]), tc, s + k)
        for n in tc:   # the caches passed in are left as they were
            assert all(torch.equal(a, b) for a, b in zip(tc[n], before[n]))
        tc = new
        assert tl.shape == (BATCH, 1, TL.vocab_pad(tcfg))
        _close_to_max(tl, jl)
        for name in jc:
            for got, want in zip(tc[name], jc[name]):
                assert got.shape == (tcfg.block_repeats,) + want.shape[1:]
                _close_to_max(got, want)


def _reference_logits_along(cfg, params, prompts, tokens,
                            tcfg) -> np.ndarray:
    """A JAX prefill-plus-decode loop, op by op, fed ``tokens`` [B, n]
    (the port's choices), its caches grown by kind: each step's logits
    over the real vocabulary."""
    s = prompts.shape[1]
    with jax.disable_jit():
        lg, c = RSS.prefill(cfg, params, jnp.asarray(prompts))
        c = _grow(tcfg, c, s + tokens.shape[1])
        out = [lg[:, -1]]
        for k in range(tokens.shape[1] - 1):
            lg, c = RSS.decode(cfg, params, jnp.asarray(tokens[:, k:k + 1]),
                               c, jnp.int32(s + k))
            out.append(lg[:, -1])
    return _f32(jnp.stack(out, 1))[..., :cfg.vocab]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_greedy_loop(arch):
    cfg, params, tcfg, tparams = _model(arch)
    s = 6
    prompts = _prompts(s, seed=30, vocab=cfg.vocab)
    toks = TSS.Engine(tcfg, tparams, s_max=s + N_NEW + 4).generate(
        torch.from_numpy(prompts), N_NEW)
    assert toks.dtype == torch.int32 and toks.shape == (BATCH, N_NEW)
    toks = toks.numpy()
    lj = _reference_logits_along(cfg, params, prompts, toks, tcfg)
    tol = LOGIT_REL * np.abs(lj).max()
    chosen = np.take_along_axis(lj, toks[..., None].astype(np.int64), -1)
    assert (chosen[..., 0] >= lj.max(-1) - tol).all()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    np.testing.assert_array_equal(toks[clear], lj.argmax(-1)[clear])


def _dropped_sequences(routes, batch: int) -> np.ndarray:
    """[B] bool: a sequence with a token whose contribution some MoE call
    dropped (``routes`` from ``layers.record_routing``)."""
    out = np.zeros(batch, bool)
    for r in routes:
        tok_dropped = (~r.keep).any(dim=1).numpy()
        out |= tok_dropped.reshape(batch, -1).any(axis=1)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_own_prefill_decode_loop(arch):
    """Engine.generate equals the port's own prefill-plus-decode loop token
    for token; each decode step's logits are within LOGIT_REL of the last
    logits of a prefill of the longer prompt, on the sequences the MoE
    dropped no token of (every sequence for the dense families)."""
    _, _, tcfg, tparams = _model(arch)
    s = 5
    prompts = torch.from_numpy(_prompts(s, seed=40, vocab=tcfg.vocab))
    got = TSS.Engine(tcfg, tparams, s_max=s + N_NEW).generate(prompts,
                                                              N_NEW)
    with TLy.record_routing() as routes:
        logits, caches = TSS.prefill(tcfg, tparams, prompts)
    caches = TSS.grow_caches(tcfg, caches, BATCH, s + N_NEW)
    dropped = _dropped_sequences(routes, BATCH)
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    want, seq, checked = [tok], prompts, 0
    for n in range(s, s + N_NEW - 1):
        logits, caches = TSS.decode(tcfg, tparams, tok, caches, n)
        seq = torch.cat([seq, tok], 1)
        with TLy.record_routing() as routes:
            full, _, _ = TL.forward_lm(tcfg, tparams, seq)
        ok = ~(dropped | _dropped_sequences(routes, BATCH))
        if tcfg.moe is None:
            assert ok.all()
        ok_t = torch.from_numpy(ok)
        if ok.any():
            _close_to_max(logits[ok_t], full[ok_t][:, -1:])
            checked += 1
        for name, c in caches.items():
            for i, t in enumerate(c):
                axis = _seq_axis(tcfg, name, i)
                assert axis is None or t.shape[axis] == s + N_NEW
        tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
        want.append(tok)
    assert checked > 0
    assert torch.equal(got, torch.cat(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_struct_matches_reference(arch):
    cfg, _, tcfg, _ = _model(arch)
    want, _ = RL.cache_struct(cfg, 2, 24)
    got = TL.cache_struct(tcfg, 2, 24)
    assert set(got) == set(want)
    for i, kind in enumerate(tcfg.layer_pattern):
        for ws, (shape, dtype, axis) in zip(want[f"l{i}"], got[f"l{i}"]):
            assert tuple(ws.shape) == shape
            assert str(dtype).removeprefix("torch.") == str(ws.dtype)
            # attention's and MLA's caches grow along the sequence; the
            # SSM state has none
            assert axis == (None if kind == "ssm" else 2)
            if axis is not None:
                assert shape[axis] == 24

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_round_trip_and_checks(arch):
    cfg, params, tcfg, tparams = _model(arch)
    ref_np = jax.tree.map(np.asarray, params)
    back = TL.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(lambda a: a, ref_np)
    mixer = bad["blocks"]["l0"]["mixer"]
    name = next(k for k in sorted(mixer) if mixer[k].ndim >= 3)
    mixer[name] = mixer[name][..., :-1]
    with pytest.raises(ValueError, match=name):
        TL.params_from_reference(tcfg, bad, CPU)
    extra = jax.tree.map(lambda a: a, ref_np)
    extra["blocks"]["l0"]["ffn"]["w_extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="w_extra"):
        TL.params_from_reference(tcfg, extra, CPU)
    missing = jax.tree.map(lambda a: a, ref_np)
    del missing["blocks"]["l0"]["norm2"]
    with pytest.raises(ValueError, match="norm2"):
        TL.params_from_reference(tcfg, missing, CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_distributions(arch):
    """The port's own init: the reference's tree, shapes and dtypes, its
    constants (zero biases, unit norms) and the spread of its draws."""
    cfg, params, tcfg, _ = _model(arch)
    p = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert jax.tree.structure(TL.params_to_numpy(p)) == \
        jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(params)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    pattern = tcfg.layer_pattern
    attn = pattern.index("attn")
    mixer = p["blocks"][f"l{attn}"]["mixer"]
    ffn = p["blocks"]["l0"]["ffn"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            assert not mixer[name].any()
    for name in ("q_norm", "k_norm", "kv_norm"):
        if name in mixer:
            assert torch.equal(mixer[name], torch.ones_like(mixer[name]))
    out = 0.02 / np.sqrt(2 * tcfg.n_layers)
    spreads = [(mixer["w_uq" if tcfg.mla else "wq"], 0.02),
               (mixer["wo"], out), (ffn["w_gate"], 0.02),
               (ffn["w_down"], out), (p["embed"], 0.02)]
    if tcfg.mla is not None:
        spreads += [(mixer[n], 0.02) for n in ("w_dkv", "w_kr", "w_uk",
                                               "w_uv", "w_dq")]
    if tcfg.moe is not None:   # the first layer whose FFN is an MoE
        first = next(i for i in range(len(pattern)) if tcfg.moe_at(i))
        moe = p["blocks"][f"l{first}"]["ffn"]
        spreads += [(moe["router"], 0.006), (moe["w_down"], out)]
        if tcfg.moe.n_shared:
            spreads.append((moe["shared"]["w_down"], out))
    for t, std in spreads:
        assert abs(float(t.std()) / std - 1) < 0.1
    again = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                 jax.tree.leaves(p)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_counts_the_matrices_of_init(arch):
    """``param_count`` leaves out the vectors (norms, biases, qk norms, the
    SSM's conv and dt biases) and counts the real vocabulary's rows of the
    embedding and head; every other leaf of the port's parameters is
    counted."""
    _, _, tcfg, tparams = _model(arch)
    pad_rows = TL.vocab_pad(tcfg) - tcfg.vocab
    total = sum(t.numel() for t in jax.tree.leaves(tparams))
    vectors = sum(t.numel() for path, t in
                  jax.tree_util.tree_leaves_with_path(tparams)
                  if "norm" in jax.tree_util.keystr(path)
                  or path[-1].key in ("bq", "bk", "bv", "conv_b", "dt_bias"))
    heads = 1 if tcfg.tie_embeddings else 2
    assert total - vectors - heads * pad_rows * tcfg.d_model == \
        tcfg.param_count()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b", "jamba-v0.1-52b"])
def test_launch_serve_prints_one_line_per_request(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "6",
         "--n-new", "4"], capture_output=True, text=True, env=env,
        timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3
    vocab = TC.get_config(arch, smoke=True).vocab
    for i, line in enumerate(lines):
        head, toks = line.split(": ", 1)
        assert head == f"req {i}"
        toks = json.loads(toks)
        assert len(toks) == 4 and all(0 <= t < vocab for t in toks)
