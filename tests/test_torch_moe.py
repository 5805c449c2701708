"""repro_torch's SwiGLU MLP and capacity-bounded MoE against the JAX
package on the CPU, on the SMOKE configs' reference-init parameters:
``mlp``; ``moe`` on qwen2-moe SMOKE and at a shape whose skewed router
overflows the capacity, with the routing compared piece by piece (the
reference's ``jax.lax.top_k`` output is recorded; its keep mask is
recounted in numpy from those expert ids); ties in the router, which
``jax.lax.top_k`` breaks lower index first. Inputs come from numpy seeds;
the JAX functions run op by op.

Tolerances:
* expert ids, the keep mask and the drop count: exact;
* gates (float32): max |Δ| ≤ 1e-6 — XLA's and torch's float32 ``exp``
  differ in the last bit;
* ``y`` (bfloat16) and ``mlp``: max |Δ| ≤ BF16_REL · max |ref|: a float32
  difference of one ulp rounds a value near a bfloat16 boundary the other
  way (the combine itself sums each token's terms in the reference's
  order, ascending expert id);
* ``aux`` (float32, a mean over tokens): relative 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as TL

BF16_REL = 1e-2
ARCH = "qwen2-moe-a2.7b"


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


def _moe_params(seed: int = 0, router_scale: float = 1.0):
    """(JAX cfg, JAX params, port cfg, port params) of one SMOKE MoE
    layer, the router multiplied by ``router_scale``."""
    cfg = ref_config(ARCH, smoke=True)
    p, _ = RL.init_moe(cfg, jax.random.key(seed))
    p = jax.tree.map(np.array, p)
    p["router"] = p["router"] * np.float32(router_scale)
    return (cfg, jax.tree.map(jnp.asarray, p), get_config(ARCH, smoke=True),
            jax.tree.map(torch.from_numpy, p))


def _reference_moe(cfg, params, x, monkeypatch):
    """The reference's (y, aux) and the (gates, expert ids) its
    ``jax.lax.top_k`` returned, op by op."""
    seen = []
    real = jax.lax.top_k

    def recording(operand, k):
        out = real(operand, k)
        seen.append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    with jax.disable_jit():
        y, aux = RL.moe(cfg, params, jnp.asarray(x).astype(jnp.bfloat16))
    monkeypatch.setattr(jax.lax, "top_k", real)
    (gates, eidx), = seen
    return y, aux, np.asarray(gates), np.asarray(eidx)


def _keep_recount(eidx: np.ndarray, capacity: int) -> np.ndarray:
    """A (token, choice) pair is kept when fewer than ``capacity`` pairs
    routed to the same expert come before it in flat [T·k] order."""
    flat = eidx.reshape(-1)
    keep = np.zeros(flat.shape, bool)
    seen: dict[int, int] = {}
    for i, e in enumerate(flat):
        keep[i] = seen.get(int(e), 0) < capacity
        seen[int(e)] = seen.get(int(e), 0) + 1
    return keep.reshape(eidx.shape)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_mlp_matches_reference(arch):
    cfg = ref_config(arch, smoke=True)
    d_ff = cfg.moe.n_shared * cfg.moe.d_ff_expert if cfg.moe else None
    p, _ = RL.init_mlp(cfg, jax.random.key(3), d_ff=d_ff)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        TL.mlp_shapes(get_config(arch, smoke=True), d_ff)
    x = _normal((2, 9, cfg.d_model), seed=4)
    want = RL.mlp(p, jnp.asarray(x).astype(jnp.bfloat16))
    got = TL.mlp(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL)


# (name, x shape, router scale): SMOKE as initialised, and a router 10×
# stronger over 128 tokens that share a common direction, which piles
# the loads onto a few experts past the capacity
MOE_CASES = [("smoke", (2, 8), 1.0), ("overflow", (4, 32), 10.0)]


def _tokens(shape, d, skewed: bool, seed: int) -> np.ndarray:
    x = _normal(shape + (d,), seed)
    if skewed:
        x = 0.5 * x + 2.0 * _normal((d,), seed + 100)
    return x


@pytest.mark.parametrize("name,shape,router_scale", MOE_CASES)
def test_moe_matches_reference(name, shape, router_scale, monkeypatch):
    cfg, jp, tcfg, tp = _moe_params(seed=5, router_scale=router_scale)
    x = _tokens(shape, cfg.d_model, name == "overflow", seed=6)
    y_ref, aux_ref, gates_ref, eidx_ref = _reference_moe(cfg, jp, x,
                                                         monkeypatch)
    with TL.record_routing() as routes:
        y, aux = TL.moe(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    (r,) = routes
    t = shape[0] * shape[1]
    cap = max(8, int(cfg.moe.capacity_factor * t * cfg.moe.top_k
                     / cfg.moe.n_experts))
    assert r.capacity == cap == TL.moe_capacity(tcfg, t)

    np.testing.assert_array_equal(r.expert_idx.numpy(), eidx_ref)
    gates_ref = gates_ref / np.maximum(gates_ref.sum(-1, keepdims=True),
                                       1e-9)
    np.testing.assert_allclose(r.gates.numpy(), gates_ref, rtol=0,
                               atol=1e-6)
    keep = _keep_recount(eidx_ref, cap)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    drops = int((~r.keep).sum())
    assert drops == int((~keep).sum())
    if name == "overflow":
        assert drops > 0
    else:
        assert drops == 0

    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    _close(y, y_ref, BF16_REL)
    assert abs(float(aux) - float(aux_ref)) <= 1e-5 * abs(float(aux_ref))


def test_overflow_drops_the_last_tokens_of_each_expert():
    """An overflowing expert keeps its first ``capacity`` pairs in flat
    token order and drops the rest."""
    cfg, jp, tcfg, tp = _moe_params(seed=5, router_scale=10.0)
    x = torch.from_numpy(_tokens((4, 32), cfg.d_model, True, seed=6)) \
        .to(torch.bfloat16)
    with TL.record_routing() as routes:
        y, _ = TL.moe(tcfg, tp, x)
    (r,) = routes
    assert (~r.keep).any()
    # the overflowing tokens are the last ones routed to their expert
    flat_e = r.expert_idx.reshape(-1)
    flat_keep = r.keep.reshape(-1)
    for e in torch.unique(flat_e[~flat_keep]).tolist():
        mine = flat_keep[flat_e == e]
        assert int(mine.sum()) == r.capacity
        assert bool(mine[:r.capacity].all()) and not mine[r.capacity:].any()


def test_top_k_lower_first_matches_jax_on_ties():
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 4, size=(64, 12)).astype(np.float32)  # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), 5)
    got_v, got_i = TL.top_k_lower_first(torch.from_numpy(vals), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_tied_router_logits_pick_the_lower_expert(monkeypatch):
    """Experts 2 and 5 share one router column, so every token's logits
    tie between them: both packages route to 2 before 5."""
    cfg, jp, tcfg, tp = _moe_params(seed=8)
    router = np.array(jp["router"])
    router[:, 5] = router[:, 2]
    router *= 40.0                       # 2/5 win often enough to matter
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _normal((2, 16, cfg.d_model), seed=9)
    _, _, _, eidx_ref = _reference_moe(cfg, jp, x, monkeypatch)
    with TL.record_routing() as routes:
        TL.moe(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    eidx = routes[0].expert_idx.numpy()
    np.testing.assert_array_equal(eidx, eidx_ref)
    both = (eidx == 2).any(1) & (eidx == 5).any(1)
    assert both.any()
    pos2 = np.argmax(eidx == 2, axis=1)
    pos5 = np.argmax(eidx == 5, axis=1)
    assert (pos2[both] < pos5[both]).all()
    # a token that picks only one of the pair picks 2
    assert not ((eidx == 5).any(1) & ~(eidx == 2).any(1)).any()


@pytest.mark.parametrize("t", [1, 4, 16, 100, 2048, 2052])
def test_moe_capacity_matches_reference_rule(t):
    for arch in ("qwen2-moe-a2.7b",):
        for smoke in (True, False):
            mo = ref_config(arch, smoke=smoke).moe
            want = max(8, int(mo.capacity_factor * t * mo.top_k
                              / mo.n_experts))
            assert TL.moe_capacity(get_config(arch, smoke=smoke), t) == want
    assert TL.moe_capacity(get_config(ARCH), 2048) == 170
    assert TL.moe_capacity(get_config(ARCH), 4) == 8


def test_record_routing_is_off_outside_the_block():
    _, _, tcfg, tp = _moe_params(seed=10)
    x = torch.from_numpy(_normal((1, 4, tcfg.d_model), seed=11)) \
        .to(torch.bfloat16)
    with TL.record_routing() as outer:
        with TL.record_routing() as inner:
            TL.moe(tcfg, tp, x)
        TL.moe(tcfg, tp, x)
    TL.moe(tcfg, tp, x)
    assert len(inner) == 1 and len(outer) == 2
    assert not TL._ROUTING_SINKS
