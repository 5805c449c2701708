"""The selective scan's gradient in repro_torch, and rematerialisation, on
the CPU: ``ref.selective_scan_bwd_ref`` (the plain version of the
``selective_scan_bwd`` kernel) against autograd through the plain loop;
``ops.selective_scan`` under autograd (its ``autograd.Function``: the
forward keeps a state every ``SCAN_CHUNK`` steps, the backward recomputes
from them) against ``jax.vjp`` of the reference's
``_selective_scan_chunked``; the chunk-state protocol at lengths that are
not a multiple of the chunk; and ``lm.forward_lm(remat=True)`` under both
``remat_policy`` values against ``remat=False``, including a backward run
on another thread (a CUDA backward runs on autograd's device thread).
Inputs come from numpy seeds, drawn as the JAX kernel tests draw them.

Tolerances: float32 gradients within SCAN_GRAD_REL of their largest
|value| (the same recurrence; autograd and the hand-written reverse sum in
other orders, XLA's and torch's ``exp`` differ in the last bit, and the
reference's associative scan multiplies the decays in another order);
rematerialised gradients bit for bit (the same ops recomputed).
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.kernels import ops, ref
from repro_torch.models import lm as TL
from repro_torch.models import perf
from repro_torch.models import ssm as TSm
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from test_torch_train_families import one_thread  # noqa: F401

SCAN_GRAD_REL = 1e-5
NAMES = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _baseline_perf():
    perf.set_perf(perf.BASELINE)
    yield
    perf.set_perf(perf.BASELINE)


def _inputs(b, s, d, n, seed=0):
    """x, dt, B, C, A, D, h0 and the cotangents dy, dh_last (numpy)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    dt = np.log1p(np.exp(normal(b, s, d))).astype(np.float32)
    return (normal(b, s, d), dt, normal(b, s, n, scale=0.5),
            normal(b, s, n, scale=0.5),
            np.exp(normal(d, n, scale=0.3)).astype(np.float32), normal(d),
            normal(b, d, n), normal(b, s, d), normal(b, d, n))


def _close(got, want, rel=SCAN_GRAD_REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (what, err, scale)


def _autograd(fn, ins, dy, dhl):
    live = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, h = fn(*live)
    loss = (y * torch.from_numpy(dy)).sum()
    if dhl is not None:
        loss = loss + (h * torch.from_numpy(dhl)).sum()
    return torch.autograd.grad(loss, live)


# (B, S, Di, N, with dh_last): S = 1, below, at and across chunk ends
SHAPES = [(2, 1, 5, 4, True), (1, 15, 6, 8, False), (2, 16, 3, 16, True),
          (2, 37, 7, 4, True), (1, 64, 4, 32, False)]


@pytest.mark.parametrize("b,s,d,n,with_dhl", SHAPES)
def test_plain_backward_matches_autograd_of_the_plain_loop(b, s, d, n,
                                                           with_dhl):
    *ins, dy, dhl = _inputs(b, s, d, n, seed=s)
    dhl = dhl if with_dhl else None
    want = _autograd(ref.selective_scan_ref, ins, dy, dhl)
    t = [torch.from_numpy(a) for a in ins]
    _, _, hc = ref.selective_scan_fwd_ref(*t, ops.SCAN_CHUNK)
    got = ref.selective_scan_bwd_ref(
        *t[:6], hc, torch.from_numpy(dy),
        None if dhl is None else torch.from_numpy(dhl), ops.SCAN_CHUNK)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, what=name)


#: SHAPES and a length of 34 chunks (16·33 + 5 steps): several of the
#: kernel's spans, the last ragged.
CHUNKED_SHAPES = SHAPES + [(1, 16 * 33 + 5, 3, 8, True)]


def _chunked_case(b, s, d, n, with_dhl):
    """Inputs of one CHUNKED_SHAPES case (numpy): x, dt, B, C, A, D, h0,
    dy and dh_last (zeros when the case has none)."""
    *ins, dy, dhl = _inputs(b, s, d, n, seed=s + 11)
    return ins, dy, dhl if with_dhl else np.zeros_like(ins[6])


@pytest.fixture(scope="module")
def _chunked_jax_grads():
    """``jax.vjp`` of the reference's ``_selective_scan_chunked`` (its
    chunk 16 where it divides S, else one chunk of S) at every
    CHUNKED_SHAPES case, traced and compiled as one program."""
    cases = [_chunked_case(*shape) for shape in CHUNKED_SHAPES]

    def grads(args):
        out = []
        for (x, *rest), dy, dhl in args:
            chunk = 16 if x.shape[1] % 16 == 0 else x.shape[1]
            _, vjp = jax.vjp(lambda *u, c=chunk:
                             RS._selective_scan_chunked(*u, c), x, *rest)
            out.append(vjp((dy, dhl)))
        return out

    args = [(list(map(jnp.asarray, ins)), jnp.asarray(dy), jnp.asarray(dhl))
            for ins, dy, dhl in cases]
    return dict(zip(CHUNKED_SHAPES, jax.jit(grads)(args)))


@pytest.mark.parametrize("shape", CHUNKED_SHAPES,
                         ids=["-".join(map(str, sh)) for sh in CHUNKED_SHAPES])
def test_chunk_parallel_backward_matches_plain_and_jax_vjp(
        shape, _chunked_jax_grads):
    """``ref.selective_scan_bwd_chunked_ref``, the decomposition the
    backward kernel computes (the chunk-local adjoint, the decay products,
    the reverse affine scan across chunks, the second walk with the true
    carry), against the plain backward on the same chunk states and
    against ``jax.vjp`` of the reference's ``_selective_scan_chunked``."""
    ins, dy, dhl = _chunked_case(*shape)
    t = [torch.from_numpy(u) for u in ins]
    tdy = torch.from_numpy(dy)
    tdhl = torch.from_numpy(dhl) if shape[4] else None
    _, _, hc = ref.selective_scan_fwd_ref(*t, ops.SCAN_CHUNK)
    got = ref.selective_scan_bwd_chunked_ref(*t[:6], hc, tdy, tdhl,
                                             ops.SCAN_CHUNK)
    plain = ref.selective_scan_bwd_ref(*t[:6], hc, tdy, tdhl,
                                       ops.SCAN_CHUNK)
    for name, g, w in zip(NAMES, got, plain):
        _close(g, w, what=name)
    for name, g, w in zip(NAMES, got, _chunked_jax_grads[shape]):
        _close(g, w, what=name)


@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_gradients_match_jax_vjp_of_the_chunked_reference(with_h0):
    """Three reference chunks of 16 (its associative scan inside each, a
    lax.scan across), from a random or zero h0, against the port's
    Function with its own chunk states."""
    b, s, d, n = 2, 48, 6, 8
    *ins, dy, dhl = _inputs(b, s, d, n, seed=7)
    if not with_h0:
        ins[6] = np.zeros_like(ins[6])

    def reference(x, dt, bb, cc, a, dsk, h0):
        return RS._selective_scan_chunked(x, dt, bb, cc, a, dsk, h0, 16)

    (y, h), vjp = jax.vjp(reference, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhl)))
    live = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    ty, th = ops.selective_scan(*live)
    _close(ty, y, 1e-5, "y")
    _close(th, h, 1e-5, "h_last")
    got = torch.autograd.grad((ty * torch.from_numpy(dy)).sum()
                              + (th * torch.from_numpy(dhl)).sum(), live)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, what=name)


@pytest.mark.parametrize("s", [1, 15, 16, 17, 50])
def test_function_saves_a_state_every_chunk(s, monkeypatch):
    """Under autograd the forward keeps [B, ceil(S / SCAN_CHUNK), Di, N]
    states, the state before steps 0, 16, 32, ...; the backward gets them
    and the gradients equal autograd through the plain loop."""
    b, d, n = 2, 3, 4
    *ins, dy, dhl = _inputs(b, s, d, n, seed=s + 100)
    seen = {}
    real = ops.selective_scan_bwd

    def spy(*args):
        seen["hc"] = args[6]
        return real(*args)

    monkeypatch.setattr(ops, "selective_scan_bwd", spy)
    live = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, h = ops.selective_scan(*live)
    assert type(y.grad_fn).__name__ == "_SelectiveScanBackward"
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (h * torch.from_numpy(dhl)).sum(), live)
    hc = seen["hc"]
    chunks = -(-s // ops.SCAN_CHUNK)
    assert tuple(hc.shape) == (b, chunks, d, n)
    t = [torch.from_numpy(a) for a in ins]
    for c in range(chunks):
        start = c * ops.SCAN_CHUNK
        if start == 0:
            want_state = t[6]
        else:
            want_state = ref.selective_scan_ref(
                *(u[:, :start] for u in t[:4]), t[4], t[5], t[6])[1]
        assert torch.equal(hc[:, c], want_state)
    want = _autograd(ref.selective_scan_ref, ins, dy, dhl)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, what=name)


def test_scan_without_autograd_is_the_plain_forward():
    """Serving (no grad, or no input requiring grad) runs the forward
    alone: no Function, no chunk states, the plain loop's values."""
    *ins, _, _ = _inputs(1, 20, 3, 4)
    t = [torch.from_numpy(a) for a in ins]
    y, h = ops.selective_scan(*t)
    assert y.grad_fn is None
    with torch.no_grad():
        y2, _ = ops.selective_scan(*[u.clone().requires_grad_(True)
                                     for u in t])
    assert y2.grad_fn is None
    wy, wh = ref.selective_scan_ref(*t)
    assert torch.equal(y, wy) and torch.equal(h, wh) and torch.equal(y2, wy)


def test_ssm_layer_trains_every_mixer_leaf():
    """Every SSM parameter gets a finite, non-zero gradient through the
    scan's Function (in_proj's x half, conv, x_proj, dt_proj, dt_bias,
    a_log and d_skip reach the loss only through the scan)."""
    cfg = TC.get_config("falcon-mamba-7b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = TP.SyntheticPipeline(cfg, TP.DataConfig(2, 20), CPU).batch_at(0)
    _, _, grads = TT.value_and_grad(cfg, params, batch)
    for name, g in grads["blocks"]["l0"]["mixer"].items():
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), name
    d_in = TSm.ssm_dims(cfg)[1]     # in_proj's x half
    assert bool((grads["blocks"]["l0"]["mixer"]["in_proj"][..., :d_in]
                 != 0).any())


REMAT_ARCHS = ["qwen3-0.6b", "jamba-v0.1-52b", "whisper-small"]


def _lm_grads(cfg, params, tokens, remat, kw):
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True), params)
    logits, aux, _ = TL.forward_lm(cfg, live, tokens, remat=remat, **kw)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(logits.shape)).astype(np.float32))
    loss = (logits.float() * w).sum() + aux
    return TO.tree_leaves(live), torch.autograd.grad(
        loss, TO.tree_leaves(live), allow_unused=True)


@pytest.mark.parametrize("policy", ["block", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_equal_no_remat(arch, policy, monkeypatch):
    """Each decoder repeat checkpointed (the encoder never is): the same
    gradients bit for bit, and the repeat's recompute really ran."""
    from torch.utils import checkpoint as CK
    cfg = TC.get_config(arch, smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.from_numpy(np.random.default_rng(4)
                                            .standard_normal((2, cfg.enc_seq,
                                                              cfg.d_model))
                                            .astype(np.float32)) \
            .to(torch.bfloat16)
    perf.set_perf(perf.PerfConfig(remat_policy=policy))
    calls = []
    real = CK.checkpoint

    def counting(*a, **k):
        calls.append(k.get("context_fn"))
        return real(*a, **k)

    monkeypatch.setattr(TL, "checkpoint", counting)
    _, want = _lm_grads(cfg, params, tokens, False, kw)
    assert calls == []
    _, got = _lm_grads(cfg, params, tokens, True, kw)
    assert len(calls) == cfg.block_repeats
    assert all((c is None) == (policy == "block") for c in calls)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def test_remat_without_autograd_changes_nothing(monkeypatch):
    """Serving's prefill (no parameter requiring grad) is not
    checkpointed."""
    cfg = TC.get_config("falcon-mamba-7b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    monkeypatch.setattr(TL, "checkpoint", None)   # would raise if called
    tokens = torch.zeros((1, 5), dtype=torch.long)
    a = TL.forward_lm(cfg, params, tokens)[0]
    b = TL.forward_lm(cfg, params, tokens, remat=False)[0]
    assert torch.equal(a, b)


def test_remat_recompute_keeps_the_forward_profile_on_another_thread():
    """The recompute runs under the profile of the forward, whatever
    thread runs the backward: a CUDA backward runs on autograd's device
    thread, where the thread-local profile is BASELINE. Under TUNED the
    forward's attention is FA-2; a recompute under BASELINE would run the
    plain scan and autograd would refuse the checkpoint."""
    cfg = TC.get_config("qwen3-0.6b", smoke=True)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True), params)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 16)))
    perf.set_perf(perf.TUNED)
    logits = TL.forward_lm(cfg, live, tokens)[0]
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(logits.float().sum(),
                                               TO.tree_leaves(live))
        except Exception as e:   # reported below, on the test's thread
            out["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert "error" not in out, out.get("error")
    perf.set_perf(perf.TUNED)
    want = torch.autograd.grad(TL.forward_lm(cfg, live, tokens,
                                             remat=False)[0].float().sum(),
                               TO.tree_leaves(live))
    for g, w in zip(out["grads"], want):
        assert torch.equal(g, w)
