"""repro_torch's ``hybrid`` family (jamba-v0.1-52b: Mamba and attention
layers interleaved, MoE on every other layer) on the CPU, on the SMOKE
config (pattern ssm, ssm, attn, ssm, repeated twice) with the JAX init's
parameters carried across by ``params_from_reference``; prompts come from
numpy seeds. ``tests/test_torch_lm_families.py`` holds the forward,
decode, cache layout and parameters against the reference; this file
holds what a mix of SSM and attention caches adds.

The prompt of 3 tokens is the conv window's length (d_conv - 1): there
the reference's ``Engine.generate``, which picks the caches to pad by
``x.shape[2] == s0``, pads the SSM conv window too. The port grows caches
by kind, so it is held against a reference prefill-plus-decode loop whose
caches are grown by kind, never against the reference's ``generate``.

Tolerances: the LM tests' ``LOGIT_REL`` (bfloat16 logits within 1e-2 of
the largest); greedy tokens are compared by feeding the JAX loop the
port's tokens (bf16 logits tie, and a one-ulp flip decides a tie).
"""
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
from repro_torch.serve import serve_step as TSS

ARCH = "jamba-v0.1-52b"
LOGIT_REL = 1e-2
BATCH, PROMPT, N_NEW = 3, 3, 6
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
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grow_by_kind(tcfg, caches, s_max):
    """The reference's caches padded along the sequence axis that the
    port's ``cache_struct`` gives each kind (none for the SSM state)."""
    struct = TL.cache_struct(tcfg, BATCH, s_max)
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


def test_config_pattern_and_moe_positions():
    """Full jamba: ssm×4, attn, ssm×3 repeated 4 times; the MoE at
    pattern positions 1, 3, 5, 7 (``moe_at`` takes the position in the
    pattern), dense SwiGLU FFNs at the others, every SSM layer with an
    FFN. SMOKE: (ssm, ssm, attn, ssm) × 2."""
    full = TC.get_config(ARCH)
    assert full.layer_pattern == ("ssm",) * 4 + ("attn",) + ("ssm",) * 3
    assert full.block_repeats == 4
    shapes = TL.param_shapes(full)["blocks"]
    for i in range(8):
        ffn = shapes[f"l{i}"]["ffn"]
        if i % 2:
            assert ffn["router"] == (4, 4096, 16)
            assert ffn["w_gate"] == (4, 16, 4096, 14336)
        else:
            assert ffn["w_gate"] == (4, 4096, 14336)
    assert "in_proj" in shapes["l0"]["mixer"] and \
        shapes["l4"]["mixer"]["wq"] == (4, 4096, 32, 128)
    smoke = TC.get_config(ARCH, smoke=True)
    assert smoke.layer_pattern == ("ssm", "ssm", "attn", "ssm")
    assert smoke.block_repeats == 2
    assert full.param_count() == ref_config(ARCH).param_count() \
        == 51_569_590_272


def test_grow_caches_pads_attention_and_keeps_the_ssm_state(model):
    """At a 3-token prompt the SSM conv window [R, B, 3, Di] has the
    prompt's length on axis 2, as attention's k/v do: ``grow_caches``
    keeps the conv and h caches as they are and pads only k/v. The
    reference's prefill caches have the same shapes, so its shape rule
    would pad the conv window too."""
    cfg, params, tcfg, tparams = model
    prompts = _prompts(PROMPT, seed=1, vocab=cfg.vocab)
    _, caches = TSS.prefill(tcfg, tparams, torch.from_numpy(prompts))
    with jax.disable_jit():
        _, jc = RSS.prefill(cfg, params, jnp.asarray(prompts))
    s_max = PROMPT + N_NEW
    grown = TSS.grow_caches(tcfg, caches, BATCH, s_max)
    for i, kind in enumerate(tcfg.layer_pattern):
        name = f"l{i}"
        (a, b), (ga, gb) = caches[name], grown[name]
        assert [tuple(t.shape) for t in caches[name]] == \
            [tuple(t.shape) for t in jc[name]]
        if kind == "ssm":
            assert a.shape[2] == PROMPT == tcfg.ssm.d_conv - 1
            assert ga is a and gb is b
        else:
            for t, g in ((a, ga), (b, gb)):
                assert g.shape == t.shape[:2] + (s_max,) + t.shape[3:]
                assert torch.equal(g[:, :, :PROMPT], t)
                assert not g[:, :, PROMPT:].any()


def test_generate_at_the_conv_window_length(model):
    """A 3-token prompt: ``Engine.generate`` equals the port's own
    prefill-plus-decode loop token for token, and a reference loop (caches
    grown by kind) fed the port's tokens gives logits within LOGIT_REL of
    the port's at every step, its greedy token the port's wherever its top
    two are further apart than the bound."""
    cfg, params, tcfg, tparams = model
    prompts = _prompts(PROMPT, seed=30, vocab=cfg.vocab)
    s_max = PROMPT + N_NEW
    got = TSS.Engine(tcfg, tparams, s_max=s_max).generate(
        torch.from_numpy(prompts), N_NEW)
    assert got.dtype == torch.int32 and got.shape == (BATCH, N_NEW)

    logits, caches = TSS.prefill(tcfg, tparams, torch.from_numpy(prompts))
    caches = TSS.grow_caches(tcfg, caches, BATCH, s_max)
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    own, steps = [tok], [logits[:, -1]]
    for n in range(PROMPT, PROMPT + N_NEW - 1):
        logits, caches = TSS.decode(tcfg, tparams, tok, caches, n)
        tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
        own.append(tok)
        steps.append(logits[:, -1])
    assert torch.equal(got, torch.cat(own, 1))
    port = torch.stack(steps, 1)[..., :cfg.vocab].float().numpy()

    toks = got.numpy()
    with jax.disable_jit():
        lg, c = RSS.prefill(cfg, params, jnp.asarray(prompts))
        c = _grow_by_kind(tcfg, c, s_max)
        ref = [lg[:, -1]]
        for k in range(N_NEW - 1):
            lg, c = RSS.decode(cfg, params, jnp.asarray(toks[:, k:k + 1]), c,
                               jnp.int32(PROMPT + k))
            ref.append(lg[:, -1])
    lj = _f32(jnp.stack(ref, 1))[..., :cfg.vocab]
    tol = LOGIT_REL * np.abs(lj).max()
    assert np.abs(port - lj).max() <= tol
    chosen = np.take_along_axis(lj, toks[..., None].astype(np.int64), -1)
    assert (chosen[..., 0] >= lj.max(-1) - tol).all()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    np.testing.assert_array_equal(toks[clear], lj.argmax(-1)[clear])


def test_padding_the_conv_window_changes_decode(model):
    """Decode from a conv window padded as the reference's ``generate``
    pads it at a 3-token prompt reads zeros where the window's inputs
    should be: its logits leave the bound around the right decode."""
    _, _, tcfg, tparams = model
    prompts = torch.from_numpy(_prompts(PROMPT, seed=2, vocab=tcfg.vocab))
    s_max = PROMPT + N_NEW
    logits, caches = TSS.prefill(tcfg, tparams, prompts)
    right = TSS.grow_caches(tcfg, caches, BATCH, s_max)
    wrong = {name: tuple(torch.nn.functional.pad(t, (0, 0, 0, s_max - PROMPT))
                         if t.ndim == 4 and t.dtype == torch.bfloat16
                         else t for t in c) for name, c in caches.items()}
    tok = TSS.greedy_token(logits[:, -1:], tcfg.vocab)
    a, _ = TSS.decode(tcfg, tparams, tok, right, PROMPT)
    b, _ = TSS.decode(tcfg, tparams, tok, wrong, PROMPT)
    scale = float(a.float().abs().max())
    assert float((a.float() - b.float()).abs().max()) > LOGIT_REL * scale


def test_generate_launches_the_scan_once_per_ssm_layer_and_step(
        model, monkeypatch):
    """The scan runs once per SSM layer and forward: 6 SSM layers of
    SMOKE's 8, at the prompt's length in the prefill and S = 1 in each of
    the n_new - 1 decode steps; attention layers launch none."""
    _, _, tcfg, tparams = model
    calls = []
    real = TO.selective_scan
    monkeypatch.setattr(TO, "selective_scan",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    prompts = torch.from_numpy(_prompts(5, seed=1, vocab=tcfg.vocab))
    TSS.Engine(tcfg, tparams, s_max=16).generate(prompts, 4)
    ssm = tcfg.layer_pattern.count("ssm") * tcfg.block_repeats
    assert ssm == 6
    assert calls == [5] * ssm + [1] * (3 * ssm)
