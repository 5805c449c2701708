"""One training step of every model family of repro_torch against the JAX
package on the CPU: dense (qwen3-0.6b), moe (qwen2-moe-a2.7b), MLA
(deepseek-v2-236b), ssm (falcon-mamba-7b), hybrid (jamba-v0.1-52b),
encdec (whisper-small) and vlm (llava-next-34b), each on its SMOKE config
with the JAX init's parameters carried across by
``lm.params_from_reference`` and one batch of each package's
``SyntheticPipeline`` (bit for bit the same). The JAX side runs op by op
(``jax.disable_jit``), as in ``tests/test_torch_lm_families.py``.

Compared: the step's metrics (``loss``, ``aux``, ``ntok``, ``grad_norm``,
``lr``), every gradient leaf, and the port's ``apply_updates`` on the
reference's gradients against the reference's own update. The updated
parameters of the two steps are not compared: at step 1 AdamW's
m̂ / √v̂ is the sign of g, so a gradient element that one bfloat16
rounding flips moves its parameter by 2·lr.

Tolerances:
* loss (float32, from bfloat16 logits): relative LOSS_REL;
* aux (float32): relative 1e-5, as ``tests/test_torch_lm_families.py``;
* gradients: max |Δ| ≤ GRAD_REL · max |ref| per leaf. The forward and
  backward round activations to bfloat16 (one ulp is 2^-8 ≈ 0.4%
  relative) and XLA's and torch's float32 ``exp`` and dot orders differ
  in the last bit, so a value near a rounding boundary rounds the other
  way, and the gradient of a weight sums such values over every token;
  1.6% of the largest magnitude measured (falcon-mamba's ``conv_w``);
  ``tests/test_torch_train_f32.py`` holds the same step in float32
  compute to 1e-5;
* grad_norm: relative GRAD_REL (the norm of those gradients); lr: 1e-6;
* AdamW on the same gradients: 1e-6 of each leaf's largest |value| (the
  same elementwise float32 arithmetic; XLA may contract a multiply-add).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.data import pipeline as RP
from repro.models import lm as RL
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.models import layers as TLy
from repro_torch.models import lm as TL
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen2-moe-a2.7b",
            "mla": "deepseek-v2-236b", "ssm": "falcon-mamba-7b",
            "hybrid": "jamba-v0.1-52b", "encdec": "whisper-small",
            "vlm": "llava-next-34b"}
LOSS_REL, GRAD_REL = 1e-4, 3e-2
BATCH, SEQ = 2, 16
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its SMOKE-sized ops
    gain nothing from more, and six xdist workers at the default thread
    count oversubscribe the cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_leaves(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of its reference leaf's largest
    |value|; the trees have the same keys."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        assert a.shape == b.shape, k
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rel * max(scale, 1e-30), (k, err, scale)


def _models(arch):
    cfg = ref_config(arch, smoke=True)
    params, _ = RL.init_params(cfg, jax.random.key(0))
    tcfg = TC.get_config(arch, smoke=True)
    tparams = TL.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), CPU)
    jb = RP.SyntheticPipeline(cfg, RP.DataConfig(BATCH, SEQ)).batch_at(0)
    tb = TP.SyntheticPipeline(tcfg, TP.DataConfig(BATCH, SEQ),
                              CPU).batch_at(0)
    return cfg, params, jb, tcfg, tparams, tb


def _reference_step(cfg, params, batch):
    """The reference's train step op by op, as its ``train_step`` runs it:
    (metrics, gradients, updated parameters)."""
    with jax.disable_jit():
        (total, m), grads = jax.value_and_grad(
            lambda p: RT.lm_loss(cfg, p, batch), has_aux=True)(params)
        new_p, _, om = RO.apply_updates(RO.AdamWConfig(), params, grads,
                                        RO.init_opt_state(params))
    return dict(m, **om, total=total), grads, new_p


def _reference_routes(cfg, params, batch, monkeypatch):
    """The expert ids the reference's forward routed, one [T, k] array a
    MoE call, op by op (its ``jax.lax.top_k`` output)."""
    seen, real = [], jax.lax.top_k

    def recording(operand, k):
        out = real(operand, k)
        seen.append(np.asarray(out[1]))
        return out

    kw = {k: batch[k] for k in ("img_embeds", "enc_frames") if k in batch}
    monkeypatch.setattr(jax.lax, "top_k", recording)
    with jax.disable_jit():
        RL.forward_lm(cfg, params, batch["tokens"], remat=False, **kw)
    monkeypatch.setattr(jax.lax, "top_k", real)
    return seen


def _port_routes(tcfg, tparams, batch):
    kw = {k: batch[k] for k in ("img_embeds", "enc_frames") if k in batch}
    with torch.no_grad(), TLy.record_routing() as routes:
        TL.forward_lm(tcfg, tparams, batch["tokens"], **kw)
    return [r.expert_idx.numpy() for r in routes]


def _check_step(arch, grad_rel, monkeypatch):
    cfg, params, jb, tcfg, tparams, tb = _models(arch)
    if tcfg.moe is not None:   # the same routing, before gradients
        want = _reference_routes(cfg, params, jb, monkeypatch)
        got = _port_routes(tcfg, tparams, tb)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jm, jg, jp = _reference_step(cfg, params, jb)
    ocfg = TO.AdamWConfig()
    _, _, tm = TT.train_step(tcfg, ocfg, tparams, TO.init_opt_state(tparams),
                             tb)
    _, _, tg = TT.value_and_grad(tcfg, tparams, tb)

    assert float(tm["ntok"]) == float(jm["ntok"]) == BATCH * SEQ
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= LOSS_REL * abs(float(jm["loss"]))
    if tcfg.moe is None:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    else:
        assert abs(float(tm["aux"]) - float(jm["aux"])) \
            <= 1e-5 * float(jm["aux"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= grad_rel * float(jm["grad_norm"])
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    _close_leaves(tg, jg, grad_rel)
    # the port's AdamW on the reference's gradients: the reference's update
    on_ref = TO.apply_updates(
        ocfg, tparams, TL.params_from_reference(
            tcfg, jax.tree.map(np.asarray, jg), CPU),
        TO.init_opt_state(tparams))[0]
    _close_leaves(on_ref, jp, 1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_reference(family, monkeypatch):
    _check_step(FAMILIES[family], GRAD_REL, monkeypatch)
