"""repro_torch's selective scan and Mamba block against the JAX package on
the CPU: the plain scan behind ``ops.selective_scan`` (CPU tensors) against
the Pallas ``selective_scan`` in interpret mode, the JAX oracle and the
model's chunked associative scan; ``causal_conv`` and ``ssm_block``
(prefill, and decode from a cache) against ``repro.models.ssm`` on the
falcon-mamba SMOKE config's parameters carried across. Inputs come from
numpy seeds.

Tolerances:
* the scan (float32): atol = rtol = 2e-4, the JAX package's own bound
  between its Pallas kernel, its oracle and its associative scan, which
  sum in other orders;
* bfloat16 block outputs: max |Δ| ≤ BF16_REL · max |ref|. One bf16 ulp is
  2^-8 ≈ 3.9e-3 relative; XLA's and torch's float32 ``exp``/``log1p`` differ
  in the last bits (softplus, silu), and the associative scan sums in
  another order than the sequential one, so a value near a rounding
  boundary rounds the other way and the change travels through the block;
* the float32 state h: max |Δ| ≤ BF16_REL · max |h|, since the scan's
  inputs are bfloat16 values that may differ by one ulp.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.kernels import ref as RR
from repro.kernels import selective_scan as RK
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.models import ssm as TS

SCAN_TOL = 2e-4
BF16_REL = 1e-2
SCAN_SHAPES = [(2, 64, 32, 8), (1, 100, 48, 16), (2, 128, 128, 16)]
ARCH = "falcon-mamba-7b"


def _scan_inputs(b, s, d, n, seed, h0=False):
    """The JAX kernel tests' distributions: x ~ N(0, 1), dt = softplus of
    N(0, 1), B and C ~ N(0, 0.25), A = exp(N(0, 0.09)), D ~ N(0, 1); h0 ~
    N(0, 1) when asked for."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.normal(size=(b, s, d)).astype(f),
           np.log1p(np.exp(rng.normal(size=(b, s, d)))).astype(f),
           (rng.normal(size=(b, s, n)) * 0.5).astype(f),
           (rng.normal(size=(b, s, n)) * 0.5).astype(f),
           np.exp(rng.normal(size=(d, n)) * 0.3).astype(f),
           rng.normal(size=d).astype(f)]
    if h0:
        out.append(rng.normal(size=(b, d, n)).astype(f))
    return out


def _port_scan(arrays):
    """ops.selective_scan on CPU tensors: the plain version, no launch."""
    before = dict(TO.LAUNCHES)
    y, h = TO.selective_scan(*(torch.from_numpy(a) for a in arrays))
    assert TO.LAUNCHES == before
    return y.numpy(), h.numpy()


def _close_to_max(got, want, rel=BF16_REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
def test_scan_ref_matches_pallas_and_oracle(b, s, d, n):
    arrays = _scan_inputs(b, s, d, n, seed=s * 7 + d)
    y, h = _port_scan(arrays)
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    jx = [jnp.asarray(a) for a in arrays]
    pallas = np.asarray(RK.selective_scan(*jx, block_d=16, chunk=32))
    np.testing.assert_allclose(y, pallas, atol=SCAN_TOL, rtol=SCAN_TOL)
    oracle = np.asarray(RR.selective_scan_ref(*jx))
    np.testing.assert_allclose(y, oracle, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 64, 32, 8, 16),
                                           (1, 100, 48, 16, 25),
                                           (2, 128, 128, 16, 64)])
def test_scan_with_h0_matches_chunked_scan(b, s, d, n, chunk):
    """y and h_last from a nonzero initial state against the model's
    associative scan (a chunk that divides S, as its reshape needs)."""
    arrays = _scan_inputs(b, s, d, n, seed=s + n, h0=True)
    y, h = _port_scan(arrays)
    x, dt, bb, cc, a, dsk, h0 = (jnp.asarray(t) for t in arrays)
    want_y, want_h = RS._selective_scan_chunked(x, dt, bb, cc, a, dsk, h0,
                                                chunk)
    np.testing.assert_allclose(y, np.asarray(want_y), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h, np.asarray(want_h), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


def test_scan_of_zero_state_equals_scan_without_one():
    arrays = _scan_inputs(2, 20, 16, 8, seed=3)
    zero = arrays + [np.zeros((2, 16, 8), np.float32)]
    for got, want in zip(_port_scan(zero), _port_scan(arrays)):
        np.testing.assert_array_equal(got, want)


def test_scan_continues_across_calls():
    """Scanning S steps at once equals scanning them in two calls, the
    second from the first's h_last (prefill then decode)."""
    x, dt, bb, cc, a, dsk = _scan_inputs(2, 12, 16, 8, seed=4)
    y, h = _port_scan([x, dt, bb, cc, a, dsk])
    y1, h1 = _port_scan([x[:, :11], dt[:, :11], bb[:, :11], cc[:, :11], a,
                         dsk])
    y2, h2 = _port_scan([x[:, 11:], dt[:, 11:], bb[:, 11:], cc[:, 11:], a,
                         dsk, h1])
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(h2, h, rtol=1e-6, atol=1e-6)


def test_scan_rejects_other_dtypes_shapes_and_mixed_devices():
    arrays = [torch.from_numpy(a) for a in _scan_inputs(1, 4, 8, 4, seed=5)]
    with pytest.raises(ValueError, match="bfloat16"):
        TO.selective_scan(arrays[0].bfloat16(), *arrays[1:])
    with pytest.raises(ValueError, match="h0"):
        TO.selective_scan(*arrays, torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="b has shape"):
        TO.selective_scan(arrays[0], arrays[1], arrays[2][:, :2], *arrays[3:])
    with pytest.raises(ValueError, match="device"):
        TO.selective_scan(arrays[0].to("meta"), *arrays[1:])


def test_scan_ref_is_the_reference_recurrence():
    """The plain version step by step in float64 numpy: h_t = exp(-dt A) h
    + dt x B, y_t = C·h_t + D x."""
    x, dt, bb, cc, a, dsk, h0 = _scan_inputs(2, 6, 5, 4, seed=6, h0=True)
    h = h0.astype(np.float64)
    ys = []
    for t in range(6):
        h = (np.exp(-dt[:, t, :, None] * a[None]) * h
             + (dt[:, t] * x[:, t])[..., None] * bb[:, t, None, :])
        ys.append((h * cc[:, t, None, :]).sum(-1) + x[:, t] * dsk)
    y, hl = TR.selective_scan_ref(*(torch.from_numpy(t) for t in
                                    (x, dt, bb, cc, a, dsk, h0)))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hl.numpy(), h, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# causal conv and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv_matches_reference(with_state, s):
    """Bit-equal in bfloat16: the same products and sums in the same order,
    each rounded to bfloat16."""
    rng = np.random.default_rng(s + 10 * with_state)
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.2).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state \
        else None
    jb = [jnp.asarray(t).astype(jnp.bfloat16) for t in (x, w, b)]
    jst = None if st is None else jnp.asarray(st).astype(jnp.bfloat16)
    want, want_state = RS._causal_conv(*jb, jst)
    tb = [torch.from_numpy(t).bfloat16() for t in (x, w, b)]
    tst = None if st is None else torch.from_numpy(st).bfloat16()
    got, got_state = TS.causal_conv(*tb, tst)
    assert got.dtype == torch.bfloat16 and got_state.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got_state.float().numpy(),
                                  np.asarray(want_state.astype(jnp.float32)))


@pytest.fixture(scope="module")
def layer():
    """SMOKE config and one mixer's parameters from the JAX init, as numpy
    and as the port's tensors."""
    cfg = ref_config(ARCH, smoke=True)
    p, _ = RS.init_ssm(cfg, jax.random.key(0))
    p = {k: np.asarray(v) for k, v in p.items()}
    return cfg, get_config(ARCH, smoke=True), p, {
        k: torch.tensor(v) for k, v in p.items()}


def test_block_parameter_shapes_match_reference(layer):
    cfg, tcfg, p, _ = layer
    assert {k: v.shape for k, v in p.items()} == TS.param_shapes(tcfg)
    assert TS.ssm_dims(tcfg)[1:] == RS._ssm_dims(cfg)[1:]


def test_ssm_block_prefill_then_decode_matches_reference(layer):
    """Prefill 16 steps, then three decode steps from each package's own
    cache: outputs and both cache tensors at every step."""
    cfg, tcfg, p, tp = layer
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jy, jstate = RS.ssm_block(cfg, p, jx[:, :16])
    ty, tstate = TS.ssm_block(tcfg, tp, tx[:, :16])
    for t in range(16, 20):
        assert ty.dtype == torch.bfloat16 and ty.shape == jy.shape
        _close_to_max(ty.float().numpy(), jy.astype(jnp.float32))
        assert tstate[0].dtype == torch.bfloat16
        assert tstate[1].dtype == torch.float32
        _close_to_max(tstate[0].float().numpy(),
                      jstate[0].astype(jnp.float32))
        _close_to_max(tstate[1].numpy(), jstate[1])
        if t == 19:
            break
        jy, jstate = RS.ssm_block(cfg, p, jx[:, t:t + 1], state=jstate)
        ty, tstate = TS.ssm_block(tcfg, tp, tx[:, t:t + 1], state=tstate)


def test_ssm_block_decode_matches_reference_decode_branch(layer):
    """S = 1 from a random state: the port's scan kernel path against the
    reference's O(1) recurrent update."""
    cfg, tcfg, p, tp = layer
    _, d_in, _ = TS.ssm_dims(tcfg)
    n = tcfg.ssm.d_state
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, 3, d_in)).astype(np.float32)
    h = (rng.normal(size=(3, d_in, n)) * 1e-3).astype(np.float32)
    jy, (jc, jh) = RS.ssm_block(
        cfg, p, jnp.asarray(x).astype(jnp.bfloat16),
        state=(jnp.asarray(conv).astype(jnp.bfloat16), jnp.asarray(h)))
    ty, (tc, th) = TS.ssm_block(
        tcfg, tp, torch.from_numpy(x).bfloat16(),
        state=(torch.from_numpy(conv).bfloat16(), torch.from_numpy(h)))
    _close_to_max(ty.float().numpy(), jy.astype(jnp.float32))
    _close_to_max(tc.float().numpy(), jc.astype(jnp.float32))
    _close_to_max(th.numpy(), jh)
    # the conv window moved by one: its first two rows are the old last two
    np.testing.assert_array_equal(tc[:, :2].float().numpy(),
                                  torch.from_numpy(conv).bfloat16()[:, 1:]
                                  .float().numpy())


def test_ssm_block_with_bfloat16_parameters_matches_reference(layer):
    """Serving weights in bfloat16 (the TUNED profile's ``serve_bf16``):
    A = exp(a_log) rounds in bfloat16 and D is widened, as the reference's
    promotions go, so prefill and decode match its block; the scan kernel
    takes float32 only, so before this the port raised."""
    cfg, tcfg, p, tp = layer
    pb = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
          for k, v in p.items()}
    tpb = {k: v.bfloat16() for k, v in tp.items()}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jy, jstate = RS.ssm_block(cfg, pb, jnp.asarray(x).astype(jnp.bfloat16))
    ty, tstate = TS.ssm_block(tcfg, tpb, torch.from_numpy(x).bfloat16())
    _close_to_max(ty.float().numpy(), jy.astype(jnp.float32))
    _close_to_max(tstate[1].numpy(), jstate[1])
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jy, _ = RS.ssm_block(cfg, pb, jnp.asarray(x1).astype(jnp.bfloat16),
                         state=jstate)
    ty, _ = TS.ssm_block(tcfg, tpb, torch.from_numpy(x1).bfloat16(),
                         state=tstate)
    _close_to_max(ty.float().numpy(), jy.astype(jnp.float32))


def test_ssm_block_runs_the_scan_once_per_call(layer, monkeypatch):
    _, tcfg, _, tp = layer
    calls = []
    real = TO.selective_scan

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(TO, "selective_scan", counting)
    x = torch.zeros((2, 5, tcfg.d_model), dtype=torch.bfloat16)
    _, state = TS.ssm_block(tcfg, tp, x)
    TS.ssm_block(tcfg, tp, x[:, :1], state=state)
    d_in = TS.ssm_dims(tcfg)[1]
    assert calls == [(2, 5, d_in), (2, 1, d_in)]
