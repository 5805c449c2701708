"""repro_torch's multi-head latent attention (DeepSeek-V2's MLA) against
the JAX package's ``init_mla`` and ``mla_attention`` on the CPU, on the
deepseek-v2 SMOKE config, one layer's parameters carried across from the
reference's init; inputs come from numpy seeds.

Tolerances (the LM tests' ``LOGIT_REL`` rule):
* outputs and the latent caches (bfloat16): max |Δ| ≤ LOGIT_REL · max
  |ref|. The two packages' bf16 products sum float32 partials in other
  orders and XLA's and torch's float32 ``exp``, ``sin`` and ``cos`` differ
  in the last bit, so a value near a bfloat16 rounding boundary (2^-8
  relative) rounds the other way;
* the cache slots decode does not write: bit for bit (they are copied).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import layers as RLy
from repro_torch import configs as TC
from repro_torch.models import layers as TLy

ARCH = "deepseek-v2-236b"
LOGIT_REL = 1e-2
B, S, S_MAX = 2, 6, 12
CPU = "cpu"


@pytest.fixture(scope="module")
def layer():
    """(JAX cfg, JAX params, port cfg, port params) of one MLA layer."""
    cfg = ref_config(ARCH, smoke=True)
    params, _ = RLy.init_mla(cfg, jax.random.key(3))
    tcfg = TC.get_config(ARCH, smoke=True)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return cfg, params, tcfg, tparams


def _bf16(a: np.ndarray):
    """The same bfloat16 values in both packages."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_to_max(got, want, rel=LOGIT_REL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("smoke", [True, False])
def test_mla_shapes_match_init_mla(smoke):
    """``mla_shapes`` is the reference's ``init_mla`` tree and shapes, at
    the full config too (traced only, nothing allocated)."""
    cfg = ref_config(ARCH, smoke=smoke)
    want = jax.eval_shape(lambda k: RLy.init_mla(cfg, k)[0],
                          jax.random.key(0))
    got = TLy.mla_shapes(TC.get_config(ARCH, smoke=smoke))
    assert set(got) == set(want)
    for name, shape in got.items():
        assert shape == want[name].shape, name
    if not smoke:
        assert got["w_uq"] == (1536, 128, 192) and got["wo"] == (128, 128,
                                                                 5120)


def test_init_mla_shapes_and_distributions():
    """The port's own init: [R, ...] stacks of the reference's shapes,
    float32, unit norms, normal·0.02 and ``wo`` ·0.02/√(2·n_layers)."""
    tcfg = TC.get_config(ARCH, smoke=True)
    p = TLy.init_mla(tcfg, torch.Generator().manual_seed(0), 3, CPU)
    for name, shape in TLy.mla_shapes(tcfg).items():
        assert tuple(p[name].shape) == (3,) + shape
        assert p[name].dtype == torch.float32
    for name in ("kv_norm", "q_norm"):
        assert torch.equal(p[name], torch.ones_like(p[name]))
    for name in ("w_dkv", "w_kr", "w_uk", "w_uv", "w_uq", "w_dq"):
        assert abs(float(p[name].std()) / 0.02 - 1) < 0.1, name
    out = 0.02 / np.sqrt(2 * tcfg.n_layers)
    assert abs(float(p["wo"].std()) / out - 1) < 0.1
    again = TLy.init_mla(tcfg, torch.Generator().manual_seed(0), 3, CPU)
    assert all(torch.equal(again[k], p[k]) for k in p)


def test_prefill_matches_reference(layer):
    """The prefill: per-head keys and values from the latent through the
    flash scan (dh = 48 against dv = 32, no grouping); the output and the
    latent caches (c_kv in the compute dtype, k_rope rotated)."""
    cfg, params, tcfg, tparams = layer
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    jx, tx = _bf16(x)
    with jax.disable_jit():
        jy, (jc, jr) = RLy.mla_attention(cfg, params, jx,
                                         positions=jnp.arange(S))
    ty, (tc, tr) = TLy.mla_attention(tcfg, tparams, tx,
                                     positions=torch.arange(S))
    assert ty.dtype == tc.dtype == tr.dtype == torch.bfloat16
    assert tuple(tc.shape) == (B, S, tcfg.mla.kv_lora)
    assert tuple(tr.shape) == (B, S, tcfg.mla.rope_head_dim)
    for got, want in ((ty, jy), (tc, jc), (tr, jr)):
        _close_to_max(got, want)


@pytest.mark.parametrize("cache_len", [1, 5, S_MAX - 1])
def test_absorbed_decode_matches_reference(layer, cache_len):
    """One absorbed decode step against seeded latent caches whose slots
    past the step hold noise (masked: attention reads positions below
    ``cache_len + 1``): the output, the slot written at ``cache_len``, and
    every other slot unchanged; the caches passed in are left as they
    were."""
    cfg, params, tcfg, tparams = layer
    m = tcfg.mla
    rng = np.random.default_rng(cache_len)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, S_MAX, m.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(B, S_MAX, m.rope_head_dim)).astype(np.float32)
    (jx, tx), (jckv, tckv), (jkr, tkr) = _bf16(x), _bf16(ckv), _bf16(kr)
    with jax.disable_jit():
        jy, (jc, jr) = RLy.mla_attention(
            cfg, params, jx, positions=jnp.full((1,), cache_len, jnp.int32),
            cache=(jckv, jkr), cache_len=jnp.int32(cache_len))
    before = (tckv.clone(), tkr.clone())
    ty, (tc, tr) = TLy.mla_attention(
        tcfg, tparams, tx, positions=torch.full((1,), cache_len),
        cache=(tckv, tkr), cache_len=cache_len)
    assert torch.equal(tckv, before[0]) and torch.equal(tkr, before[1])
    _close_to_max(ty, jy)
    for got, want, old in ((tc, jc, tckv), (tr, jr, tkr)):
        _close_to_max(got[:, cache_len], want[:, cache_len])
        keep = [i for i in range(S_MAX) if i != cache_len]
        assert torch.equal(got[:, keep], old[:, keep])
        np.testing.assert_array_equal(_f32(got[:, keep]),
                                      _f32(want[:, keep]))


def test_decode_masks_the_slots_past_the_step(layer):
    """Noise in the slots past ``cache_len`` does not reach the output:
    decode from caches that differ only there gives the same bits."""
    _, _, tcfg, tparams = layer
    m, cache_len = tcfg.mla, 4
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((B, 1, tcfg.d_model), generator=gen).to(torch.bfloat16)
    ckv = torch.randn((B, S_MAX, m.kv_lora), generator=gen) \
        .to(torch.bfloat16)
    kr = torch.randn((B, S_MAX, m.rope_head_dim), generator=gen) \
        .to(torch.bfloat16)
    noisy_ckv, noisy_kr = ckv.clone(), kr.clone()
    noisy_ckv[:, cache_len + 1:] *= 7
    noisy_kr[:, cache_len + 1:] *= -3
    pos = torch.full((1,), cache_len)
    a, _ = TLy.mla_attention(tcfg, tparams, x, positions=pos,
                             cache=(ckv, kr), cache_len=cache_len)
    b, _ = TLy.mla_attention(tcfg, tparams, x, positions=pos,
                             cache=(noisy_ckv, noisy_kr),
                             cache_len=cache_len)
    assert torch.equal(a, b)


def test_decode_equals_the_last_row_of_a_longer_prefill(layer):
    """The absorbed decode of token s from a prefill of s tokens against
    the last row of a prefill of s + 1: the same attention, computed
    through the latent instead of per-head keys and values."""
    _, _, tcfg, tparams = layer
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S + 1, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    full, _ = TLy.mla_attention(tcfg, tparams, x,
                                positions=torch.arange(S + 1))
    _, (c, r) = TLy.mla_attention(tcfg, tparams, x[:, :S],
                                  positions=torch.arange(S))
    grow = [torch.nn.functional.pad(t, (0, 0, 0, S_MAX - S)) for t in (c, r)]
    dec, _ = TLy.mla_attention(tcfg, tparams, x[:, S:],
                               positions=torch.full((1,), S),
                               cache=tuple(grow), cache_len=S)
    _close_to_max(dec, full[:, S:])
