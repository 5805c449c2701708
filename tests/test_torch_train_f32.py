"""The training step of ``tests/test_torch_train_families.py`` with both
packages' compute dtype set to float32 (the backward's arithmetic without
bfloat16 roundings), and ``microbatches`` against one batch. A file of its
own so that xdist can run it beside the bfloat16 one.

Tolerances: gradients within GRAD_REL_F32 of each leaf's largest |value|
(about 1e-6 at most on the SMOKE families: XLA's and torch's float32 ``exp``
and dot orders differ in the last bit); the other quantities as in the
bfloat16 file.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as RLy
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.models import layers as TLy
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS_
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from test_torch_train_families import CPU, FAMILIES, SEQ, _check_step, \
    _close_leaves, one_thread  # noqa: F401

#: hybrid (jamba: SSM, attention and MoE layers) and MLA (deepseek-v2,
#: with MoE) cover every mixer and FFN kind of the seven families.
F32_FAMILIES = ["hybrid", "mla"]
GRAD_REL_F32 = 1e-5


@pytest.mark.parametrize("family", F32_FAMILIES)
def test_train_step_in_float32_matches_reference(family, monkeypatch):
    """The same step with both packages' compute dtype set to float32:
    the backward's arithmetic without bfloat16 roundings, held to
    GRAD_REL_F32 (about 1e-6 at most on the SMOKE families). Not encdec: its
    encoder's output is the frames' bfloat16 in both packages, so the
    cross-attention's k/v gradients keep bfloat16 roundings (2.2e-4 of
    their largest value measured)."""
    for mod, dt in ((RLy, jnp.float32), (RS, jnp.float32),
                    (TLy, torch.float32), (TS_, torch.float32)):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", dt)
    _check_step(FAMILIES[family], GRAD_REL_F32, monkeypatch)


def test_microbatches_equal_one_batch_in_float32(monkeypatch):
    """``microbatches=2`` accumulates float32 gradients over two halves of
    the batch: with every label counted and equal halves, the same step
    as one batch: the metrics, and the moments (m is 0.1 · the clipped
    gradient, v 0.05 · its square) to float32 rounding. The parameters
    are not compared: m̂ / (√v̂ + eps) turns a last-bit difference of a
    gradient element near eps into a visible move."""
    for mod in (TLy, TS_):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    tcfg = TC.get_config("qwen3-0.6b", smoke=True)
    params = TL.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    batch = TP.SyntheticPipeline(tcfg, TP.DataConfig(4, SEQ),
                                 CPU).batch_at(3)
    ocfg = TO.AdamWConfig(warmup_steps=1)
    one = TT.train_step(tcfg, ocfg, params, TO.init_opt_state(params), batch)
    two = TT.train_step(tcfg, ocfg, params, TO.init_opt_state(params), batch,
                        microbatches=2)
    for k in ("loss", "grad_norm", "total"):
        assert abs(float(one[2][k]) - float(two[2][k])) \
            <= 1e-6 * abs(float(one[2][k])), k
    assert float(one[2]["lr"]) == float(two[2]["lr"])
    _close_leaves(two[1].m, one[1].m, 1e-5)
    _close_leaves(two[1].v, one[1].v, 1e-5)
