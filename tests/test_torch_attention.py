"""repro_torch's attention layers against the JAX package on the CPU:
``pad_heads``, ``rope_freqs``/``apply_rope``, ``flash_attention`` (1, 2
and 4 KV blocks, causal and not, ``q_offset`` 0 and > 0, one query head a
KV head and groups of 4), ``decode_attention`` at several lengths, and
``attention`` with ``qkv_bias`` and ``qk_norm`` in prefill and decode, on
the reference init's parameters (biases and norms redrawn so that they
matter). Inputs come from numpy seeds; the JAX functions run op by op.

Tolerances:
* float32 paths (RoPE, the flash scan, decode attention on float32
  inputs): max |Δ| ≤ F32_REL · max |ref|. XLA's and torch's float32
  ``sin``/``cos``/``exp`` differ in the last bit, and their float32 dots
  sum in other orders;
* bfloat16 outputs (RoPE, ``attention``): max |Δ| ≤ BF16_REL · max |ref|.
  One bf16 ulp is 2^-8 ≈ 3.9e-3 relative, and a float32 difference of one
  ulp rounds a value near a bf16 boundary the other way;
* the KV cache (bfloat16) likewise; the positions a decode step does not
  write equal the cache it was given, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models import lm as RLM
from repro_torch.configs import get_config
from repro_torch.models import layers as TL

F32_REL = 1e-5
BF16_REL = 1e-2


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _normal(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("h,kv", [(16, 16), (16, 32), (32, 8), (12, 2),
                                  (12, 5), (4, 4)])
def test_pad_heads_matches_reference_at_tp1(h, kv):
    assert TL.pad_heads(h, kv) == RL.pad_heads(h, kv, 1)
    assert TL.pad_heads(h, kv, 16) == RL.pad_heads(h, kv, 16)


@pytest.mark.parametrize("dh,theta", [(32, 1e4), (128, 1e6)])
def test_rope_freqs_match_reference(dh, theta):
    _close(TL.rope_freqs(dh, theta), RL.rope_freqs(dh, theta), F32_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 4093])
def test_apply_rope_matches_reference(dtype, offset):
    x = _normal((2, 4, 16, 64), seed=1)
    pos = np.arange(offset, offset + 16, dtype=np.int32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = RL.apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos), 1e6)
    got = TL.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                        1e6)
    assert got.dtype == td
    _close(got, want, F32_REL if dtype == "float32" else BF16_REL)


def test_apply_rope_rotates_split_halves():
    """Dimension i pairs with i + dh/2 (not 2i with 2i + 1): a vector with
    only dimension 0 set gains dimension dh/2 at position 1."""
    x = torch.zeros((1, 8))
    x[0, 0] = 1.0
    out = TL.apply_rope(x, torch.tensor([1]), 1e4)
    assert torch.allclose(out[0, [0, 4]], torch.tensor(
        [np.cos(1.0), np.sin(1.0)], dtype=torch.float32))
    assert not out[0, [1, 2, 3, 5, 6, 7]].any()


@pytest.mark.parametrize("n_blk", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 24])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_flash_attention_matches_reference(n_blk, causal, q_offset, h, kv):
    sk, sq, dh = 64, 40, 32
    q = _normal((2, h, sq, dh), seed=2)
    k = _normal((2, kv, sk, dh), seed=3)
    v = _normal((2, kv, sk, dh), seed=4)
    block = sk // n_blk
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, q_offset=q_offset, block=block)
    got = TL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, q_offset=q_offset,
                             block=block)
    assert got.dtype == torch.float32
    _close(got, want, F32_REL)


def test_flash_attention_block_rule_and_bf16():
    """``block`` larger than the keys gives one block; a bf16 q gives a
    bf16 output (the scan itself is float32)."""
    q = _normal((1, 4, 24, 32), seed=5)
    k = _normal((1, 2, 24, 32), seed=6)
    v = _normal((1, 2, 24, 32), seed=7)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = RL.flash_attention(jq, jk, jv, True)
    got = TL.flash_attention(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL)
    # the rescaling across blocks is part of the result: 3 blocks of 8
    _close(TL.flash_attention(tq.float(), tk.float(), tv.float(), True,
                              block=8),
           RL.flash_attention(jq.astype(jnp.float32),
                              jk.astype(jnp.float32),
                              jv.astype(jnp.float32), True, block=8),
           F32_REL)


@pytest.mark.parametrize("length", [1, 7, 20, 32])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_decode_attention_matches_reference(length, h, kv):
    q = _normal((3, h, 32), seed=8)
    kc = _normal((3, 32, kv, 32), seed=9)
    vc = _normal((3, 32, kv, 32), seed=10)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(length))
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), length)
    _close(got, want, F32_REL)
    # positions at or past ``length`` take no part
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, length:] = 50.0
    vc2[:, length:] = -50.0
    again = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc2),
                                torch.from_numpy(vc2), length)
    assert torch.equal(again, got)


def _attention_params(arch: str, seed: int):
    """(JAX cfg, JAX layer-0 params, port cfg, port params) on SMOKE, with
    random biases and norms so that ``qkv_bias``/``qk_norm`` matter."""
    cfg = ref_config(arch, smoke=True)
    p, _ = RL.init_attention(cfg, jax.random.key(seed))
    p = {k: np.array(v) for k, v in p.items()}
    for i, name in enumerate(sorted(p)):
        if name[0] == "b":
            p[name] = _normal(p[name].shape, seed + i, 0.1)
        elif name.endswith("norm"):
            p[name] = 1 + _normal(p[name].shape, seed + i, 0.2)
    return (cfg, {k: jnp.asarray(v) for k, v in p.items()},
            get_config(arch, smoke=True),
            {k: torch.from_numpy(v) for k, v in p.items()})


ATTN_ARCHS = ["qwen2-1.5b", "qwen3-0.6b", "qwen2-moe-a2.7b", "granite-3-2b"]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_prefill_and_decode_match_reference(arch):
    """Prefill over 12 tokens, then two decode steps writing at 12 and 13
    into caches grown to 20, each against the reference's ``attention``."""
    cfg, jp, tcfg, tp = _attention_params(arch, seed=11)
    assert set(tp) == set(TL.attention_shapes(tcfg))
    assert all(tuple(tp[k].shape) == s
               for k, s in TL.attention_shapes(tcfg).items())
    s, s_max = 12, 20
    x = _normal((2, s, cfg.d_model), seed=12)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        jy, (jk, jv) = RL.attention(cfg, jp, jx, positions=jnp.arange(s))
    ty, (tk, tv) = TL.attention(tcfg, tp, tx, positions=torch.arange(s))
    assert ty.dtype == torch.bfloat16 and tk.dtype == torch.bfloat16
    _close(ty, jy, BF16_REL)
    _close(tk, jk, BF16_REL)
    _close(tv, jv, BF16_REL)

    def grow(c, pad):
        return pad(c, [(0, 0), (0, s_max - s), (0, 0), (0, 0)])

    jc = (grow(jk, jnp.pad), grow(jv, jnp.pad))
    tc = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, s_max - s))
               for c in (tk, tv))
    for n in (s, s + 1):
        xt = _normal((2, 1, cfg.d_model), seed=20 + n)
        with jax.disable_jit():
            jy, jc = RL.attention(cfg, jp, jnp.asarray(xt).astype(
                jnp.bfloat16), positions=jnp.full((1,), n, jnp.int32),
                cache=jc, cache_len=jnp.int32(n))
        before = tuple(c.clone() for c in tc)
        ty, new = TL.attention(tcfg, tp, torch.from_numpy(xt).to(
            torch.bfloat16), positions=torch.full((1,), n), cache=tc,
            cache_len=n)
        assert all(torch.equal(a, b) for a, b in zip(tc, before))
        for a, b in zip(new, tc):      # only position n was written
            keep = torch.ones(s_max, dtype=torch.bool)
            keep[n] = False
            assert torch.equal(a[:, keep], b[:, keep])
        tc = new
        _close(ty, jy, BF16_REL)
        for a, b in zip(tc, jc):
            _close(a, b, BF16_REL)


def test_attention_cache_width_follows_pad_heads():
    """qwen2-moe (16 heads over 16 kv) keeps 16 kv heads; qwen3-4b (32
    over 8) keeps 8: the cache's KV axis is ``pad_heads``' second value,
    as the reference's ``cache_struct`` gives it."""
    from repro.configs import get_config as rc
    from repro_torch.models import lm as TLM
    for arch in ("qwen2-moe-a2.7b", "qwen3-4b"):
        cfg, tcfg = rc(arch), get_config(arch)
        want, _ = RLM.cache_struct(cfg, 2, 64)
        got = TLM.cache_struct(tcfg, 2, 64)
        for ws, (gs, gd, axis) in zip(want["l0"], got["l0"]):
            assert tuple(ws.shape) == gs and axis == 2
            assert str(ws.dtype) == "bfloat16" and gd == torch.bfloat16
