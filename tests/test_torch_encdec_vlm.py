"""repro_torch's ``encdec`` (whisper-small) and ``vlm`` (llava-next-34b)
families against the JAX package on the CPU, on their SMOKE configs with
the JAX init's parameters carried across by ``params_from_reference``:
cross-attention (``attention(kv_input=)`` and ``attention_fixed_kv``), the
encoder, the cross k/v, ``forward_lm`` with audio frames and with image
embeddings, ``decode_step``, greedy ``Engine.generate``, the synthetic
data pipeline, the parameter and cache layouts and the launcher. Inputs
come from each package's ``SyntheticPipeline`` at seed 0, prompts past
the pipeline's from numpy seeds. The JAX functions run op by op
(``jax.disable_jit``), as in ``tests/test_torch_lm_families.py``.

Tolerances:
* logits, caches, cross k/v and attention outputs (bfloat16): max |Δ| ≤
  LOGIT_REL · max |ref| (the ``LOGIT_REL`` rule of
  ``tests/test_torch_lm.py``: one bf16 ulp is 2^-8 ≈ 3.9e-3 relative, and
  XLA's and torch's float32 ``exp``, ``sin``, ``cos`` and dot orders round
  a value near a boundary the other way);
* greedy tokens: the JAX loop is fed the port's tokens, and each must be
  within the logit bound of that step's JAX maximum; where JAX's top two
  logits are further apart than the bound, the port's token is JAX's;
* decode against the port's own prefill of one more token: LOGIT_REL;
* the pipeline's batches: bit for bit.
"""
import dataclasses
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
from repro.data import pipeline as RP
from repro.models import layers as RLy
from repro.models import lm as RL
from repro.serve import serve_step as RSS
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.models import layers as TLy
from repro_torch.models import lm as TL
from repro_torch.serve import serve_step as TSS

ROOT = Path(__file__).resolve().parents[1]
WHISPER, LLAVA = "whisper-small", "llava-next-34b"
LOGIT_REL = 1e-2
BATCH, N_NEW = 2, 5
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


def _batches(arch, s: int, step: int = 0):
    """(the reference's batch, the port's) at seed 0: tokens [B, s] and
    the modality input of the family."""
    data = dict(batch=BATCH, seq_len=s, seed=0)
    ref = RP.SyntheticPipeline(ref_config(arch, smoke=True),
                               RP.DataConfig(**data)).batch_at(step)
    port = TP.SyntheticPipeline(TC.get_config(arch, smoke=True),
                                TP.DataConfig(**data), CPU).batch_at(step)
    return ref, port


def _modality(batch) -> dict:
    return {k: batch[k] for k in ("img_embeds", "enc_frames") if k in batch}


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


def _rel_to_max(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _grow(caches, s_max):
    """The reference's attention caches [R, B, S, KV, dh] padded to
    ``s_max`` along the sequence."""
    return {n: tuple(jnp.pad(x, [(0, 0), (0, 0), (0, s_max - x.shape[2]),
                                 (0, 0), (0, 0)]) for x in c)
            for n, c in caches.items()}


def _layer0(tree, key):
    """The first repeat of ``blocks.l0[key]`` (JAX tree or torch dict)."""
    sub = tree["blocks"]["l0"][key]
    if isinstance(next(iter(sub.values())), torch.Tensor):
        return TL._index(sub, 0)
    return jax.tree.map(lambda a: a[0], sub)


def _bf16(seed: int, shape) -> np.ndarray:
    """Seeded normal values, already on the bfloat16 grid (float32)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# The data pipeline, configs and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_pipeline_batches_are_the_references_bit_for_bit(arch, step):
    cfg = TC.get_config(arch, smoke=True)
    ref, port = _batches(arch, 12, step)
    assert set(port) == set(ref)
    want = {"tokens", "labels"} | {"vlm": {"img_embeds"},
                                   "encdec": {"enc_frames"}}.get(
        cfg.family, set())
    assert set(port) == want
    for name in ("tokens", "labels"):
        assert port[name].dtype == torch.int32
        np.testing.assert_array_equal(port[name].numpy(),
                                      np.asarray(ref[name]))
    assert torch.equal(port["labels"][:, :-1], port["tokens"][:, 1:])
    for name in want - {"tokens", "labels"}:
        got, exp = port[name], np.asarray(ref[name])
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == exp.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      exp.view(np.int16))


def test_pipeline_is_pure_and_iterates_its_steps():
    cfg = TC.get_config(WHISPER, smoke=True)
    pipe = TP.SyntheticPipeline(cfg, TP.DataConfig(2, 8, seed=5), CPU)
    it = iter(pipe)
    for step in range(3):
        a, b = next(it), pipe.batch_at(step)
        assert all(torch.equal(a[k], b[k]) for k in a)
    other = TP.SyntheticPipeline(cfg, TP.DataConfig(2, 8, seed=6), CPU)
    assert not torch.equal(other.batch_at(0)["tokens"],
                           pipe.batch_at(0)["tokens"])


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_param_shapes_and_count_match_reference(arch):
    cfg, params, tcfg, tparams = _model(arch)
    shapes = TL.param_shapes(tcfg)
    want = jax.tree.map(lambda a: tuple(a.shape), params)
    assert jax.tree.structure(shapes, is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.structure(want, is_leaf=lambda x:
                                         isinstance(x, tuple))
    assert jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    # encdec: a cross block on every decoder layer and an encoder whose
    # FFN is dense; vlm: neither
    encdec = cfg.family == "encdec"
    assert ("enc_blocks" in shapes) == ("enc_final_norm" in shapes) == encdec
    assert all(("cross" in b) == ("norm_x" in b) == encdec
               for b in shapes["blocks"].values())
    if encdec:
        enc = shapes["enc_blocks"]["l0"]
        assert enc["norm1"] == (tcfg.n_enc_layers, tcfg.d_model)
        assert set(enc["ffn"]) == {"w_gate", "w_up", "w_down"}
    for smoke in (True, False):
        assert TC.get_config(arch, smoke).param_count() == \
            ref_config(arch, smoke=smoke).param_count()
    # param_count leaves out the vectors (norms) and the padded vocabulary
    total = sum(t.numel() for t in jax.tree.leaves(tparams))
    vectors = sum(t.numel() for path, t in
                  jax.tree_util.tree_leaves_with_path(tparams)
                  if "norm" in jax.tree_util.keystr(path))
    pad_rows = TL.vocab_pad(tcfg) - tcfg.vocab
    assert total - vectors - 2 * pad_rows * tcfg.d_model == \
        tcfg.param_count()


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_full_config_counts(arch):
    """The full configs: whisper-small whole, llava-next-34b's 34.39 B and
    the 20 of its 60 layers the card runs."""
    cfg = TC.get_config(arch)
    if arch == WHISPER:
        assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
                cfg.head_dim, cfg.enc_seq) == (12, 12, 768, 12, 64, 1500)
        assert TL.vocab_pad(cfg) == 51968
    else:
        assert cfg.n_img_tokens == 2880 and TL.vocab_pad(cfg) == 64000
        assert cfg.param_count() == 34_388_049_920
        cut = dataclasses.replace(cfg, n_layers=20)
        assert cut.param_count() == 12_074_352_640


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_init_params_shapes_and_distributions(arch):
    cfg, params, tcfg, _ = _model(arch)
    p = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert jax.tree.structure(TL.params_to_numpy(p)) == \
        jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(params)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    out = 0.02 / np.sqrt(2 * tcfg.n_layers)
    blk = p["blocks"]["l0"]
    spreads = [(blk["mixer"]["wq"], 0.02), (blk["mixer"]["wo"], out),
               (blk["ffn"]["w_down"], out), (p["embed"], 0.02)]
    if tcfg.family == "encdec":
        enc = p["enc_blocks"]["l0"]
        spreads += [(blk["cross"]["wk"], 0.02), (blk["cross"]["wo"], out),
                    (enc["mixer"]["wv"], 0.02), (enc["ffn"]["w_up"], 0.02)]
        for t in (blk["norm_x"], enc["norm1"], p["enc_final_norm"]):
            assert torch.equal(t, torch.ones_like(t))
    for t, std in spreads:
        assert abs(float(t.std()) / std - 1) < 0.1


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_params_from_reference_round_trip(arch):
    _, params, tcfg, tparams = _model(arch)
    ref_np = jax.tree.map(np.asarray, params)
    back = TL.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)
    if tcfg.family == "encdec":
        missing = jax.tree.map(lambda a: a, ref_np)
        del missing["enc_blocks"]
        with pytest.raises(ValueError, match="enc_blocks"):
            TL.params_from_reference(tcfg, missing, CPU)


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_cache_structs_match_reference(arch):
    cfg, _, tcfg, _ = _model(arch)
    want, _ = RL.cache_struct(cfg, 2, 24)
    got = TL.cache_struct(tcfg, 2, 24)
    assert set(got) == set(want)
    for name in want:
        for ws, (shape, dtype, axis) in zip(want[name], got[name]):
            assert (tuple(ws.shape), str(ws.dtype), axis) == \
                (shape, str(dtype).removeprefix("torch."), 2)
    want, _ = RL.cross_kv_struct(cfg, 3)
    got = TL.cross_kv_struct(tcfg, 3)
    assert set(got) == set(want)
    for name in want:
        for ws, (shape, dtype, axis) in zip(want[name], got[name]):
            # the cross k/v keep the encoder's length: no axis grows
            assert (tuple(ws.shape), str(ws.dtype), axis) == \
                (shape, str(dtype).removeprefix("torch."), None)
            assert shape[2] == tcfg.enc_seq


# ---------------------------------------------------------------------------
# Cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_rope", [False, True])
def test_attention_over_kv_input_matches_reference(use_rope):
    """``attention(kv_input=)`` with whisper's first cross block: q from x,
    k and v from the memory, non-causal; the flash scan over S_enc keys."""
    cfg, params, tcfg, tparams = _model(WHISPER)
    x = _bf16(1, (BATCH, 7, cfg.d_model))
    mem = _bf16(2, (BATCH, cfg.enc_seq, cfg.d_model))
    kw = dict(causal=False, use_rope=use_rope)
    with jax.disable_jit():
        jy, (jk, jv) = RLy.attention(
            cfg, _layer0(params, "cross"), jnp.asarray(x, jnp.bfloat16),
            positions=jnp.arange(7), kv_input=jnp.asarray(mem, jnp.bfloat16),
            **kw)
    ty, (tk, tv) = TLy.attention(
        tcfg, _layer0(tparams, "cross"),
        torch.from_numpy(x).to(torch.bfloat16), positions=torch.arange(7),
        kv_input=torch.from_numpy(mem).to(torch.bfloat16), **kw)
    assert ty.dtype == torch.bfloat16 and tuple(tk.shape) == jk.shape
    assert tk.shape[1] == cfg.enc_seq
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close_to_max(got, want)


def test_attention_fixed_kv_matches_reference():
    cfg, params, tcfg, tparams = _model(WHISPER)
    _, kv = TLy.pad_heads(cfg.n_heads, cfg.n_kv)
    x = _bf16(3, (BATCH, 1, cfg.d_model))
    k = _bf16(4, (BATCH, cfg.enc_seq, kv, cfg.head_dim))
    v = _bf16(5, (BATCH, cfg.enc_seq, kv, cfg.head_dim))
    with jax.disable_jit():
        jy = RLy.attention_fixed_kv(
            cfg, _layer0(params, "cross"), jnp.asarray(x, jnp.bfloat16),
            *(jnp.asarray(t, jnp.bfloat16) for t in (k, v)))
    ty = TLy.attention_fixed_kv(
        tcfg, _layer0(tparams, "cross"),
        torch.from_numpy(x).to(torch.bfloat16),
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (k, v)))
    assert ty.shape == (BATCH, 1, cfg.d_model) and ty.dtype == torch.bfloat16
    _close_to_max(ty, jy)
    # every one of the S_enc positions is attended: the last changes it
    v2 = torch.from_numpy(v).to(torch.bfloat16)
    v2[:, -1] += 4
    ty2 = TLy.attention_fixed_kv(
        tcfg, _layer0(tparams, "cross"),
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(k).to(torch.bfloat16), v2)
    assert not torch.equal(ty, ty2)


def test_encode_and_cross_kvs_match_reference():
    cfg, params, tcfg, tparams = _model(WHISPER)
    ref, port = _batches(WHISPER, 4)
    with jax.disable_jit():
        jm = RL._encode(cfg, params, ref["enc_frames"])
        jx = RL.cross_kvs_from_memory(cfg, params, jm)
    tm = TL._encode(tcfg, tparams, port["enc_frames"])
    assert tm.dtype == torch.bfloat16
    assert tm.shape == (BATCH, cfg.enc_seq, cfg.d_model)
    _close_to_max(tm, jm)
    tx = TL.cross_kvs_from_memory(tcfg, tparams, tm)
    assert set(tx) == set(jx)
    for name in jx:
        for got, want in zip(tx[name], jx[name]):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == want.shape == (
                tcfg.n_layers, BATCH, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
            _close_to_max(got, want)


def test_encoder_is_bidirectional():
    """A change to the last frame reaches the encoder's output at the
    first position (non-causal), and the decoder's self-attention stays
    causal: a change to the last prompt token leaves earlier logits."""
    _, _, tcfg, tparams = _model(WHISPER)
    _, port = _batches(WHISPER, 6)
    frames = port["enc_frames"].clone()
    m0 = TL._encode(tcfg, tparams, frames)
    frames[:, -1] += 1
    m1 = TL._encode(tcfg, tparams, frames)
    assert not torch.equal(m0[:, 0], m1[:, 0])
    toks = port["tokens"].clone()
    a, _, _ = TL.forward_lm(tcfg, tparams, toks,
                            enc_frames=port["enc_frames"])
    toks[:, -1] = (toks[:, -1] + 1) % tcfg.vocab
    b, _, _ = TL.forward_lm(tcfg, tparams, toks,
                            enc_frames=port["enc_frames"])
    assert torch.equal(a[:, :-1], b[:, :-1])


def test_encdec_needs_its_cross_memory():
    _, _, tcfg, tparams = _model(WHISPER)
    _, port = _batches(WHISPER, 4)
    with pytest.raises(ValueError, match="cross"):
        TL.forward_lm(tcfg, tparams, port["tokens"])
    memory = TL._encode(tcfg, tparams, port["enc_frames"])
    with pytest.raises(ValueError, match="not both"):
        TL.forward_lm(tcfg, tparams, port["tokens"], memory=memory,
                      enc_frames=port["enc_frames"])
    a, _, _ = TL.forward_lm(tcfg, tparams, port["tokens"], memory=memory)
    b, _, _ = TL.forward_lm(tcfg, tparams, port["tokens"],
                            enc_frames=port["enc_frames"])
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# forward_lm and decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 3])
@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_forward_lm_matches_reference(arch, s):
    """Logits and the collected caches; vlm's span the image tokens."""
    cfg, params, tcfg, tparams = _model(arch)
    ref, port = _batches(arch, s)
    with jax.disable_jit():
        jl, jaux, jc = RL.forward_lm(cfg, params, ref["tokens"], remat=False,
                                     collect_cache=True, **_modality(ref))
    tl, aux, tc = TL.forward_lm(tcfg, tparams, port["tokens"],
                                collect_cache=True, **_modality(port))
    total = s + (tcfg.n_img_tokens if arch == LLAVA else 0)
    assert tl.dtype == torch.bfloat16
    assert tl.shape == (BATCH, total, TL.vocab_pad(tcfg)) == jl.shape
    _close_to_max(tl, jl)
    assert float(aux) == float(jaux) == 0.0
    assert set(tc) == set(jc)
    for name in jc:
        for got, want in zip(tc[name], jc[name]):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == want.shape
            assert got.shape[2] == total
            _close_to_max(got, want)


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_decode_step_matches_reference(arch):
    """Two decode steps from each package's own prefill caches, grown:
    whisper with the cross k/v, llava at cache_len = n_img + s."""
    cfg, params, tcfg, tparams = _model(arch)
    s = 6
    ref, port = _batches(arch, s)
    n_img = tcfg.n_img_tokens if arch == LLAVA else 0
    s_max = n_img + s + 4
    nxt = _prompts(2, seed=20, vocab=cfg.vocab)
    with jax.disable_jit():
        _, jc = RSS.prefill(cfg, params, ref["tokens"], **_modality(ref))
        jx = None
        if arch == WHISPER:
            jx = RL.cross_kvs_from_memory(
                cfg, params, RL._encode(cfg, params, ref["enc_frames"]))
    jc = _grow(jc, s_max)
    _, tc = TSS.prefill(tcfg, tparams, port["tokens"], **_modality(port))
    tc = TSS.grow_caches(tcfg, tc, BATCH, s_max)
    tx = None
    if arch == WHISPER:
        tx = TL.cross_kvs_from_memory(
            tcfg, tparams, TL._encode(tcfg, tparams, port["enc_frames"]))
    for k in range(2):
        n = n_img + s + k
        with jax.disable_jit():
            jl, jc = RL.decode_step(cfg, params,
                                    jnp.asarray(nxt[:, k:k + 1]), jc,
                                    jnp.int32(n), cross_kvs=jx)
        tl, tc = TSS.decode(tcfg, tparams, torch.from_numpy(nxt[:, k:k + 1]),
                            tc, n, tx)
        assert tl.shape == (BATCH, 1, TL.vocab_pad(tcfg))
        _close_to_max(tl, jl)
        for name in jc:
            for got, want in zip(tc[name], jc[name]):
                assert tuple(got.shape) == want.shape
                _close_to_max(got, want)
    if arch == WHISPER:
        # the cross k/v decide the step: zeroed, the logits move
        zeroed = {n: tuple(torch.zeros_like(t) for t in c)
                  for n, c in tx.items()}
        tz, _ = TSS.decode(tcfg, tparams, torch.from_numpy(nxt[:, :1]),
                           TSS.grow_caches(tcfg, TSS.prefill(
                               tcfg, tparams, port["tokens"],
                               **_modality(port))[1], BATCH, s_max),
                           s, zeroed)
        assert _rel_to_max(tz, jl) > LOGIT_REL


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _decode_vs_prefill_rel(tcfg, tparams, tokens, modality, n_img: int,
                           cache_len: int) -> float:
    """The port's decode for token s (written and attending at
    ``cache_len``) against the last logits of its prefill of s + 1
    tokens, relative to the largest."""
    b, s = tokens.shape
    logits, caches = TSS.prefill(tcfg, tparams, tokens, **modality)
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    caches = TSS.grow_caches(tcfg, caches, b, n_img + s + 1)
    cross = None
    if "enc_frames" in modality:
        cross = TL.cross_kvs_from_memory(
            tcfg, tparams, TL._encode(tcfg, tparams, modality["enc_frames"]))
    dec, _ = TSS.decode(tcfg, tparams, tok, caches, cache_len, cross)
    full, _, _ = TL.forward_lm(tcfg, tparams, torch.cat([tokens, tok], 1),
                               **modality)
    return _rel_to_max(dec[:, 0], full[:, -1])


def test_whisper_generate_matches_reference_greedy_loop():
    cfg, params, tcfg, tparams = _model(WHISPER)
    s = 6
    ref, port = _batches(WHISPER, s)
    toks = TSS.Engine(tcfg, tparams, s_max=s + N_NEW + 4).generate(
        port["tokens"], N_NEW, enc_frames=port["enc_frames"])
    assert toks.dtype == torch.int32 and toks.shape == (BATCH, N_NEW)
    toks = toks.numpy()
    with jax.disable_jit():
        jx = RL.cross_kvs_from_memory(
            cfg, params, RL._encode(cfg, params, ref["enc_frames"]))
        lg, c = RSS.prefill(cfg, params, ref["tokens"],
                            enc_frames=ref["enc_frames"])
        c = _grow(c, s + N_NEW)
        out = [lg[:, -1]]
        for k in range(N_NEW - 1):
            lg, c = RSS.decode(cfg, params, jnp.asarray(toks[:, k:k + 1]),
                               c, jnp.int32(s + k), cross_kvs=jx)
            out.append(lg[:, -1])
    lj = _f32(jnp.stack(out, 1))[..., :cfg.vocab]
    tol = LOGIT_REL * np.abs(lj).max()
    chosen = np.take_along_axis(lj, toks[..., None].astype(np.int64), -1)
    assert (chosen[..., 0] >= lj.max(-1) - tol).all()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    np.testing.assert_array_equal(toks[clear], lj.argmax(-1)[clear])


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_generate_equals_own_prefill_decode_loop(arch):
    """Engine.generate equals the port's own prefill-plus-decode loop token
    for token, decoding at n_img + s0 + i with the caches grown to
    n_img + s_max; each step's logits are within LOGIT_REL of the last
    logits of a prefill of the longer prompt."""
    _, _, tcfg, tparams = _model(arch)
    s = 5
    _, port = _batches(arch, s)
    modality = _modality(port)
    n_img = tcfg.n_img_tokens if arch == LLAVA else 0
    got = TSS.Engine(tcfg, tparams, s_max=s + N_NEW).generate(
        port["tokens"], N_NEW, **modality)
    cross = None
    if arch == WHISPER:
        cross = TL.cross_kvs_from_memory(
            tcfg, tparams, TL._encode(tcfg, tparams, port["enc_frames"]))
    logits, caches = TSS.prefill(tcfg, tparams, port["tokens"], **modality)
    caches = TSS.grow_caches(tcfg, caches, BATCH, n_img + s + N_NEW)
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    want, seq = [tok], port["tokens"]
    for n in range(n_img + s, n_img + s + N_NEW - 1):
        logits, caches = TSS.decode(tcfg, tparams, tok, caches, n, cross)
        seq = torch.cat([seq, tok], 1)
        full, _, _ = TL.forward_lm(tcfg, tparams, seq, **modality)
        _close_to_max(logits, full[:, -1:])
        for c in caches.values():
            assert all(t.shape[2] == n_img + s + N_NEW for t in c)
        tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
        want.append(tok)
    assert torch.equal(got, torch.cat(want, 1))


def test_whisper_generate_encodes_once(monkeypatch):
    _, _, tcfg, tparams = _model(WHISPER)
    _, port = _batches(WHISPER, 4)
    calls, real = [], TL._encode

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(TL, "_encode", counted)
    TSS.Engine(tcfg, tparams, s_max=8).generate(
        port["tokens"], 3, enc_frames=port["enc_frames"])
    assert len(calls) == 1


def test_llava_decode_at_the_image_offset_matches_reference_prefill():
    """The reference's own prefill of s + 1 (text after the image) and the
    port's decode at cache_len = n_img + s: within LOGIT_REL."""
    cfg, params, tcfg, tparams = _model(LLAVA)
    s = 6
    ref, port = _batches(LLAVA, s)
    logits, caches = TSS.prefill(tcfg, tparams, port["tokens"],
                                 img_embeds=port["img_embeds"])
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    caches = TSS.grow_caches(tcfg, caches, BATCH, cfg.n_img_tokens + s + 1)
    dec, _ = TSS.decode(tcfg, tparams, tok, caches, cfg.n_img_tokens + s)
    with jax.disable_jit():
        full, _, _ = RL.forward_lm(
            cfg, params, jnp.concatenate([ref["tokens"],
                                          jnp.asarray(tok.numpy())], 1),
            img_embeds=ref["img_embeds"], remat=False)
    _close_to_max(dec[:, 0], full[:, -1])


def test_reference_generate_decodes_llava_at_the_text_offset():
    """A reference caveat pinned: the reference's ``Engine.generate``
    (``repro/serve/serve_step.py:57-72``) keeps llava's caches
    n_img + s0 long (its ``grow`` pads only a sequence of s0) and decodes
    the first new token at ``cache_len = s0``, writing over an image
    token's k/v and attending to s0 + 1 positions. Its first step, run op
    by op as it runs it, misses its own prefill of s + 1 by more than
    LOGIT_REL; the port's decode at n_img + s0 does not."""
    cfg, params, tcfg, tparams = _model(LLAVA)
    s = 6
    ref, port = _batches(LLAVA, s)
    with jax.disable_jit():
        lg, caches = RSS.prefill(cfg, params, ref["tokens"],
                                 img_embeds=ref["img_embeds"])
        assert all(x.shape[2] == cfg.n_img_tokens + s
                   for c in caches.values() for x in c)
        tok = RSS.greedy_token(lg[:, -1:, :], cfg.vocab)
        dec, _ = RSS.decode(cfg, params, tok, caches, jnp.int32(s))
        full, _, _ = RL.forward_lm(cfg, params,
                                   jnp.concatenate([ref["tokens"], tok], 1),
                                   img_embeds=ref["img_embeds"], remat=False)
    assert _rel_to_max(dec[:, 0], full[:, -1]) > LOGIT_REL
    modality = _modality(port)
    right = _decode_vs_prefill_rel(tcfg, tparams, port["tokens"], modality,
                                   cfg.n_img_tokens, cfg.n_img_tokens + s)
    wrong = _decode_vs_prefill_rel(tcfg, tparams, port["tokens"], modality,
                                   cfg.n_img_tokens, s)
    assert right <= LOGIT_REL < wrong


def test_generate_rejects_more_tokens_than_s_max():
    _, _, tcfg, tparams = _model(LLAVA)
    _, port = _batches(LLAVA, 6)
    with pytest.raises(ValueError, match="s_max"):
        TSS.Engine(tcfg, tparams, s_max=8).generate(
            port["tokens"], 3, img_embeds=port["img_embeds"])


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
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
