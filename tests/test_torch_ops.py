"""repro_torch.kernels (the plain versions behind ``ops.lane_cumsum``,
``ops.frontier_min`` and ``ops.minplus_sweep`` on CPU tensors) against the
JAX package's Pallas kernels in interpret mode and its ``kernels.ref``
oracles, on the same numpy-seeded inputs. All three are exact: int32 sums
and float32 sums of small integers have one answer in any order, and min
is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR


def _launches_unchanged(fn):
    """Run ``fn`` and check that no kernel launch was counted (CPU tensors
    take the plain path)."""
    before = dict(TO.LAUNCHES)
    out = fn()
    assert TO.LAUNCHES == before
    return out


# ---------------------------------------------------------------------------
# lane_cumsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,k", [(64, 4), (1000, 20), (2048, 128), (777, 33),
                                 (1, 16)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_lane_cumsum_matches_pallas(s, k, dtype):
    """int32 with negative values, and float32 holding small integers."""
    rng = np.random.default_rng(s * 131 + k)
    x = rng.integers(-5, 10, size=(s, k)).astype(dtype)
    got = _launches_unchanged(lambda: TO.lane_cumsum(torch.from_numpy(x)))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (s, k)
    pallas = np.asarray(RO.lane_cumsum(jnp.asarray(x), block_s=256))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RR.cumsum_lanes(jnp.asarray(x))))
    np.testing.assert_array_equal(TR.cumsum_lanes(torch.from_numpy(x)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("k,x_ptr,want", [
    (16, 0, 4),                 # DFEP's rank inputs: one 16-byte load
    (16, 256, 4),
    (16, 4, 1),                 # a view 4 bytes into its storage
    (16, 8, 1),
    (1, 0, 1),
    (4, 0, 4),
    (33, 0, 1),
    (300, 0, 4),
    (301, 0, 1),
])
def test_cumsum_vec(k, x_ptr, want):
    """The host's choice for a lane_cumsum launch: the columns a thread
    loads at once (the kernel's source sizes the tiles and the scratch)."""
    assert TO.cumsum_vec(k, x_ptr, 0) == want
    assert TO.cumsum_vec(k, x_ptr, 8) == 1                # out misaligned


def test_lane_cumsum_rejects_other_dtypes():
    with pytest.raises(ValueError, match="int64"):
        TO.lane_cumsum(torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\[S, K\]"):
        TO.lane_cumsum(torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# frontier_min
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,v", [(4, 100), (20, 5000), (7, 333), (16, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontier_min_matches_pallas(k, v, dtype):
    """Exact in float32 and bfloat16; the last column has no member."""
    rng = np.random.default_rng(k * 7 + v)
    state = (rng.random((k, v)) * 100).astype(np.float32)
    member = rng.random((k, v)) < 0.4
    member[:, -1] = False
    tdt = getattr(torch, dtype)
    st = torch.from_numpy(state).to(tdt)
    got = _launches_unchanged(
        lambda: TO.frontier_min(st, torch.from_numpy(member)))
    assert got.dtype == tdt and got.shape == (v,)
    js = jnp.asarray(state).astype(getattr(jnp, dtype))
    pallas = RO.frontier_min(js, jnp.asarray(member), block_v=512)
    want = np.asarray(pallas, np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(RR.kreduce_min(js, jnp.asarray(member)), np.float32))
    assert np.isinf(got[-1].float().item())


@pytest.mark.parametrize("v,elem,ptrs,want", [
    (317_080, 4, (0, 0, 0), 4),            # dblp's [16, V] ETSCH state
    (8 * 317_080, 4, (0, 0, 0), 4),        # multi-source SSSP's [16, S·V]
    (4100, 4, (0, 0, 0), 4),
    (4099, 4, (0, 0, 0), 1),
    (4097, 4, (0, 0, 0), 1),
    (4096, 2, (0, 0, 0), 8),               # bfloat16: 16-byte state loads
    (317_080, 2, (0, 0, 0), 8),
    (4100, 2, (0, 0, 0), 4),
    (4096, 4, (4, 0, 0), 1),               # state view 4 bytes in
    (4096, 4, (8, 0, 0), 1),
    (4096, 2, (8, 0, 0), 4),               # bf16 state 8 bytes in
    (4096, 2, (0, 4, 0), 4),               # member 4 bytes in
    (4096, 4, (0, 3, 0), 1),
    (4096, 2, (0, 0, 16), 8),
])
def test_frontier_min_vec(v, elem, ptrs, want):
    """The vertex columns a frontier_min thread owns: the widest that
    divides V and that the state, member and out pointers allow."""
    assert TO.frontier_min_vec(v, elem, *ptrs) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontier_min_nan_matches_pallas(dtype):
    """A NaN in a member slot gives NaN, one in a non-member slot is
    ignored, as in the Pallas kernel."""
    rng = np.random.default_rng(11)
    state = (rng.random((5, 64)) * 100).astype(np.float32)
    member = rng.random((5, 64)) < 0.5
    member[:, :3] = [True, False, False]
    state[0, 0] = state[1, 1] = np.nan       # member / non-member slot
    tdt = getattr(torch, dtype)
    got = TO.frontier_min(torch.from_numpy(state).to(tdt),
                          torch.from_numpy(member)).float().numpy()
    pallas = RO.frontier_min(jnp.asarray(state).astype(getattr(jnp, dtype)),
                             jnp.asarray(member), block_v=128)
    np.testing.assert_array_equal(got, np.asarray(pallas, np.float32))
    assert np.isnan(got[0]) and not np.isnan(got[1]) and np.isinf(got[2])


def test_frontier_min_all_masked_is_inf():
    state = torch.ones((3, 50), dtype=torch.float32)
    member = torch.zeros((3, 50), dtype=torch.bool)
    assert torch.isinf(TO.frontier_min(state, member)).all()


def test_frontier_min_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float64"):
        TO.frontier_min(torch.zeros((2, 3), dtype=torch.float64),
                        torch.ones((2, 3), dtype=torch.bool))


# ---------------------------------------------------------------------------
# minplus_sweep
# ---------------------------------------------------------------------------

def _sweep_case(v: int, e: int, seed: int):
    """Random edges with duplicates and self-targets, ~10% masked, dist
    finite on ~30% of the vertices (some negative) and +inf elsewhere."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[: e // 10] = src[e // 10: 2 * (e // 10)]        # duplicate edges
    dst[: e // 10] = dst[e // 10: 2 * (e // 10)]
    dst[-5:] = src[-5:]                                  # self-targets
    mask = rng.random(e) < 0.9
    dist = np.where(rng.random(v) < 0.3, rng.random(v) * 10 - 2,
                    np.inf).astype(np.float32)
    return dist, src, dst, mask


@pytest.mark.parametrize("v,e", [(100, 300), (513, 1000)])
@pytest.mark.parametrize("cost", [1.0, 0.0])
def test_minplus_sweep_matches_pallas(v, e, cost):
    dist, src, dst, mask = _sweep_case(v, e, seed=v + e)
    args = [torch.from_numpy(a) for a in (dist, src, dst, mask)]
    got = _launches_unchanged(lambda: TO.minplus_sweep(*args, cost=cost))
    jargs = [jnp.asarray(a) for a in (dist, src, dst, mask)]
    pallas = np.asarray(RO.minplus_sweep(*jargs, cost=cost, block_v=256,
                                         block_e=256))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RR.minplus_relax(*jargs, cost=cost)))
    assert (got.numpy() <= dist).all()


def test_minplus_sweep_is_jacobi():
    """On the path 0-1-2-…-9 from vertex 0, one sweep reaches exactly one
    hop further: candidates come from the input, not from values the same
    sweep has already lowered (Gauss–Seidel would run down the path)."""
    n = 10
    src = torch.arange(n - 1, dtype=torch.int32)
    dst = src + 1
    mask = torch.ones(n - 1, dtype=torch.bool)
    dist = torch.full((n,), float("inf"))
    dist[0] = 0.0
    for hop in range(1, n):
        dist = TO.minplus_sweep(dist, src, dst, mask)
        want = np.where(np.arange(n) <= hop, np.arange(n), np.inf)
        np.testing.assert_array_equal(dist.numpy(), want.astype(np.float32))
    pallas = RO.minplus_sweep(jnp.asarray(want.astype(np.float32)),
                              jnp.asarray(src.numpy()),
                              jnp.asarray(dst.numpy()),
                              jnp.asarray(mask.numpy()), block_v=128,
                              block_e=128)
    np.testing.assert_array_equal(
        np.asarray(pallas), TO.minplus_sweep(dist, src, dst, mask).numpy())


def test_minplus_sweep_rejects_other_dtypes_and_mixed_devices():
    idx = torch.zeros(3, dtype=torch.int32)
    mask = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="float64"):
        TO.minplus_sweep(torch.zeros(4, dtype=torch.float64), idx, idx, mask)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        TO.minplus_sweep(torch.zeros(4, device="meta"), idx, idx, mask)
