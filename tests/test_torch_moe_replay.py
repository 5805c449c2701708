"""``layers.replay_routing``: a prefill of qwen2-moe-a2.7b (SMOKE) that
replays a recorded routing sends every token to the recorded experts,
whatever its own router would choose, and otherwise runs as usual: its
own routing replayed changes no bit, and another model's router is
overridden, capacity slots and drops included."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import serve_step as SS

ARCH = "qwen2-moe-a2.7b"


def _setup(seed: int = 0):
    cfg = get_config(ARCH, smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (3, 16)))
    return cfg, params, prompts


def _prefill(cfg, params, prompts, experts=None):
    replay = (L.replay_routing(experts) if experts is not None
              else torch.no_grad())
    with torch.no_grad(), replay, L.record_routing() as routes:
        logits = SS.prefill(cfg, params, prompts)[0]
    return logits, routes


def test_replaying_a_run_s_own_routing_changes_nothing():
    cfg, params, prompts = _setup()
    logits, routes = _prefill(cfg, params, prompts)
    again, replayed = _prefill(cfg, params, prompts,
                               [r.expert_idx for r in routes])
    assert torch.equal(again, logits)
    assert len(replayed) == len(routes) == cfg.n_layers
    for a, b in zip(routes, replayed):
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)


def test_replayed_routing_overrides_another_router():
    """A second model differs only in its routers: on its own it routes
    otherwise; replaying the first model's experts, in any order within a
    token, routes and drops as the first model did."""
    cfg, params, prompts = _setup()
    _, routes = _prefill(cfg, params, prompts)
    gen = torch.Generator().manual_seed(1)
    other = {**params, "blocks": {
        name: {**blk, "ffn": {**blk["ffn"], "router": 0.02 * torch.randn(
            blk["ffn"]["router"].shape, generator=gen)}}
        for name, blk in params["blocks"].items()}}
    _, own = _prefill(cfg, other, prompts)
    assert any(not torch.equal(a.expert_idx.sort(-1)[0],
                               b.expert_idx.sort(-1)[0])
               for a, b in zip(routes, own))
    experts = [r.expert_idx.flip(-1) for r in routes]
    _, replayed = _prefill(cfg, other, prompts, experts)
    for want, got, e in zip(routes, replayed, experts):
        assert torch.equal(got.expert_idx, e)
        kept = lambda r: torch.where(r.keep, r.expert_idx, -1).sort(-1)[0]
        assert torch.equal(kept(got), kept(want))
        assert torch.allclose(got.gates.sum(-1), torch.ones(()))


def test_a_call_past_the_replay_raises():
    cfg, params, prompts = _setup()
    _, routes = _prefill(cfg, params, prompts)
    with pytest.raises(IndexError):
        _prefill(cfg, params, prompts, [r.expert_idx for r in routes[:1]])
