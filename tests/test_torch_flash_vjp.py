"""repro_torch's FA-2 attention backward (``models/flash_vjp.py``) and the
perf profile (``models/perf.py``) against the JAX package on the CPU:
``flash_fa2``'s output and gradients against the reference's
``flash_fa2`` and against autograd through the port's plain flash scan
(causal and not, GQA, MLA's dv ≠ dh, and Sk = 2,049, where the FA-2 block
rule takes one block of all keys); ``flash_attention``'s dispatch and its
``additive_mask`` and ``pv_bf16`` knobs; and one train step under TUNED
against BASELINE, as ``tests/test_flash_vjp.py`` holds the reference.
Inputs come from numpy seeds.

Tolerances (float32 inputs): outputs and gradients within FLASH_REL of
their largest |value| (the same float32 sums in other orders: the
reference scales q before the product in its plain scan and the scores
after it in FA-2, and XLA's and torch's ``exp`` differ in the last bit);
``pv_bf16`` within PV_REL (the probabilities and values rounded to
bfloat16: 2^-8 relative each); TUNED against BASELINE losses within 1e-2
absolute, the reference's own bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import flash_vjp as RF
from repro.models import layers as RLy
from repro.models import perf as RP
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.models import flash_vjp as TF
from repro_torch.models import layers as TLy
from repro_torch.models import lm as TL
from repro_torch.models import perf
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from test_torch_train_families import one_thread  # noqa: F401

FLASH_REL, PV_REL = 1e-5, 2e-2
CPU = "cpu"


@pytest.fixture(autouse=True)
def _baseline_perf():
    perf.set_perf(perf.BASELINE)
    yield
    perf.set_perf(perf.BASELINE)


def _qkv(b, h, kv, s, dh, dv, seed=0, sq=None):
    rng = np.random.default_rng(seed)
    sq = s if sq is None else sq
    return tuple((0.3 * rng.standard_normal(shape)).astype(np.float32)
                 for shape in ((b, h, sq, dh), (b, kv, s, dh), (b, kv, s, dv)))


def _close(got, want, rel=FLASH_REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _port_grads(fn, q, k, v, seed=9):
    """fn's output and the gradients of sum(out · w) for a seeded w."""
    live = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = fn(*live)
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(out.shape)).astype(np.float32))
    return (out, *torch.autograd.grad((out * w).sum(), live)), w.numpy()


CASES = [
    # (b, h, kv, s, dh, dv, causal, block)
    (2, 4, 4, 128, 32, 32, True, 64),       # MHA causal
    (2, 8, 2, 256, 32, 32, True, 64),       # GQA
    (1, 4, 4, 64, 16, 48, True, 64),        # MLA-style dv != dh
    (2, 4, 2, 128, 32, 32, False, 64),      # bidirectional (encoder)
    (1, 2, 1, 2049, 16, 16, True, 2049),    # Sk = 2,049: one block
]


@pytest.mark.parametrize("b,h,kv,s,dh,dv,causal,block", CASES)
def test_fa2_matches_reference_and_plain_autograd(b, h, kv, s, dh, dv,
                                                  causal, block):
    q, k, v = _qkv(b, h, kv, s, dh, dv)
    (out, dq, dk, dv_), w = _port_grads(
        lambda *a: TF.flash_fa2(*a, causal, block), q, k, v)
    # the reference's FA-2, forward and VJP
    r_out, vjp = jax.vjp(lambda *a: RF.flash_fa2(*a, causal, block),
                         *map(jnp.asarray, (q, k, v)))
    r_grads = vjp(jnp.asarray(w))
    for got, want in zip((out, dq, dk, dv_), (r_out, *r_grads)):
        _close(got, want)
    # autograd through the port's plain scan (BASELINE) in the same blocks
    (p_out, *p_grads), _ = _port_grads(
        lambda *a: TLy.flash_attention(*a, causal=causal, block=block),
        q, k, v)
    for got, want in zip((out, dq, dk, dv_), (p_out, *p_grads)):
        _close(got, want)


def test_fa2_block_rule_takes_keys_the_plain_scan_cannot_split():
    """At Sk = 2,049 the plain scan's 2 blocks of 1,024 keys cannot split
    the keys and raise; under ``flash_custom_vjp`` the reference's rule
    takes one block of all 2,049, and matches the reference."""
    q, k, v = _qkv(1, 2, 1, 2049, 16, 16, seed=3, sq=2049)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(RuntimeError):
        TLy.flash_attention(tq, tk, tv, causal=True)
    perf.set_perf(perf.TUNED)
    got = TLy.flash_attention(tq, tk, tv, causal=True)
    RP.set_perf(RP.TUNED)
    try:
        want = RLy.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    finally:
        RP.set_perf(RP.BASELINE)
    _close(got, want)


def test_flash_attention_dispatches_to_fa2_only_from_position_zero(
        monkeypatch):
    calls = []
    real = TLy.flash_fa2

    def counting(*a):
        calls.append(a[3:])
        return real(*a)

    monkeypatch.setattr(TLy, "flash_fa2", counting)
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 64, 16, 16))
    TLy.flash_attention(q, k, v, causal=True, block=32)
    assert calls == []
    perf.set_perf(perf.TUNED)
    TLy.flash_attention(q, k, v, causal=True, block=32)
    TLy.flash_attention(q, k, v, causal=False, block=48)   # 64 % 48 != 0
    TLy.flash_attention(q, k, v, causal=True, q_offset=5, block=32)
    assert calls == [(True, 32), (False, 64)]


@pytest.mark.parametrize("knob", ["additive_mask", "pv_bf16"])
def test_perf_knobs_of_the_plain_scan_match_the_reference(knob):
    """The plain scan (no FA-2) under one knob against the reference's
    under the same knob, and against the port's BASELINE scan: the
    additive mask gives the same result; pv_bf16 within PV_REL."""
    q, k, v = _qkv(2, 4, 2, 128, 32, 32, seed=5)
    cfg = perf.PerfConfig(**{knob: True})
    base = TLy.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block=32)
    perf.set_perf(cfg)
    got = TLy.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, block=32)
    RP.set_perf(RP.PerfConfig(**{knob: True}))
    try:
        with jax.disable_jit():
            want = RLy.flash_attention(*map(jnp.asarray, (q, k, v)),
                                       causal=True, block=32)
    finally:
        RP.set_perf(RP.BASELINE)
    _close(got, want)
    if knob == "additive_mask":
        assert torch.equal(got, base)
    else:
        _close(got, base, PV_REL)


def test_perf_config_mirrors_the_reference():
    assert perf.PerfConfig.__dataclass_fields__.keys() == \
        RP.PerfConfig.__dataclass_fields__.keys()
    for name in ("BASELINE", "TUNED"):
        assert vars(getattr(perf, name)) == vars(getattr(RP, name))
    assert perf.get_perf() == perf.BASELINE


def test_ssm_bf16_raises():
    cfg = TC.get_config("falcon-mamba-7b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    perf.set_perf(perf.PerfConfig(ssm_bf16=True))
    with pytest.raises(ValueError, match="ssm_bf16"):
        TL.forward_lm(cfg, params, torch.zeros((1, 4), dtype=torch.long))


def test_tuned_profile_numerics_match_baseline():
    """One train step under TUNED stays within the reference's bound of
    BASELINE (same math, FA-2's backward and the additive mask)."""
    cfg = TC.get_config("qwen3-0.6b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = TP.SyntheticPipeline(cfg, TP.DataConfig(2, 64), CPU).batch_at(0)
    ocfg = TO.AdamWConfig(warmup_steps=1, total_steps=10)
    out = {}
    for name, pc in (("base", perf.BASELINE), ("tuned", perf.TUNED)):
        perf.set_perf(pc)
        out[name] = TT.train_step(cfg, ocfg, params,
                                  TO.init_opt_state(params), batch)
    assert abs(float(out["base"][2]["loss"])
               - float(out["tuned"][2]["loss"])) < 1e-2
    assert abs(float(out["base"][2]["grad_norm"])
               - float(out["tuned"][2]["grad_norm"])) \
        < 1e-2 * float(out["base"][2]["grad_norm"])


def test_tuned_profile_ssm_numerics():
    cfg = TC.get_config("falcon-mamba-7b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)))
    outs = {}
    for name, pc in (("base", perf.BASELINE), ("tuned", perf.TUNED)):
        perf.set_perf(pc)
        outs[name] = TL.forward_lm(cfg, params, toks, remat=False)[0]
    assert torch.equal(outs["base"], outs["tuned"])
