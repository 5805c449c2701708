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


# ---------------------------------------------------------------------------
# minplus_sweep's target-sorted layout
# ---------------------------------------------------------------------------

def _layout_case(groups: int, v: int, seed: int):
    """Flat edges of ``groups`` groups of ``v`` rows (indices ``k·v + x``)
    with a hub per group, a long row, self-loops, padding slots (0, 0),
    and, in group 0, endpoints outside the state."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for k in range(groups):
        e = 6 * v
        s = rng.integers(0, v, e)
        d = rng.integers(0, v, e)
        d[: 3 * v // 2] = 1                       # hub row 1
        s[3 * v // 2: 3 * v // 2 + 40] = 2        # a long row: 2
        d[-30:] = s[-30:]                         # self-loops
        s[-60:-30] = d[-60:-30] = 0               # padding slots
        src.append(s + k * v)
        dst.append(d + k * v)
    src, dst = np.concatenate(src), np.concatenate(dst)
    n = groups * v
    src[:3], dst[3:6] = [-1, n, n + 5], [-7, n, 2 * n]
    mask = rng.random(src.size) < 0.9
    mask[-60:-30] = False
    dist = np.where(rng.random(n) < 0.4, rng.random(n) * 10 - 2,
                    np.inf).astype(np.float32)
    return dist, src.astype(np.int32), dst.astype(np.int32), mask


@pytest.fixture
def small_classes(monkeypatch):
    """Row kinds and tiles small enough for a test graph to hold all."""
    monkeypatch.setattr(TO, "MINPLUS_SHORT", 4)
    monkeypatch.setattr(TO, "MINPLUS_WARP", 30)
    monkeypatch.setattr(TO, "MINPLUS_HUB", 64)
    monkeypatch.setattr(TO, "MINPLUS_TILE_ROWS", (16, 32, 64))
    monkeypatch.setattr(TO, "MINPLUS_TILE_EDGES", 64)


def _tiles(lay):
    """Per tile: (first layout row, short entries, other entries)."""
    ent, tp = lay.entries.numpy(), lay.tile_ptr.numpy()
    per_group = -(-lay.group_rows // lay.tile_rows)
    for t in range(lay.n_tiles):
        row0 = ((t // per_group) * lay.group_rows
                + (t % per_group) * lay.tile_rows)
        yield (row0, ent[tp[2 * t]: tp[2 * t + 1]],
               ent[tp[2 * t + 1]: tp[2 * t + 2]])


def _layout_rows(lay):
    """(target, other, edge id, kind, position) of every half-edge the
    layout hands to a tile or a unit, the tiles' entries and the units'
    rows checked for order and kind."""
    he, units = lay.half_edges.numpy(), lay.rows.numpy()
    tp = lay.tile_ptr.numpy()
    bits, low = lay.local_bits, (1 << lay.local_bits) - 1
    assert tp[0] == 0 and tp[-1] == len(lay.entries)
    assert (np.diff(tp) >= 0).all() and len(tp) == 2 * lay.n_tiles + 1
    seen, skipped = [], []
    for row0, shorts, others in _tiles(lay):
        for chunk in (shorts, others):
            local = chunk[:, 1] & low
            assert (np.diff(local) > 0).all()
            assert (local < lay.tile_rows).all()
            assert (row0 % lay.group_rows + local < lay.group_rows).all()
        skipped.extend(row0 + (others[:, 1] & low))
        assert (others[:, 1] >> bits == 0).all()
        for first, word in shorts:
            deg = word >> bits
            assert 0 < deg <= TO.MINPLUS_SHORT
            seen.extend((row0 + (word & low), *he[i], 0, i)
                        for i in range(first, first + deg))
    assert sorted(units[:, 0]) == sorted(skipped)
    kinds = np.repeat([3, 2, 1], lay.counts)
    assert len(kinds) == len(units)
    for kind in (3, 2, 1):      # each kind by falling in-degree, then row
        deg = (units[:, 2] - units[:, 1])[kinds == kind]
        keys = list(zip(-deg, units[kinds == kind, 0]))
        assert keys == sorted(keys)
        assert (TO.minplus_row_kind(torch.from_numpy(deg)).numpy()
                == kind).all()
    for (row, first, end, _), kind in zip(units, kinds):
        seen.extend((row, *he[i], kind, i) for i in range(first, end))
    return seen


@pytest.mark.parametrize("loops", [False, True])
@pytest.mark.parametrize("groups", [1, 4])
def test_minplus_layout_holds_every_half_edge_once(small_classes, groups,
                                                   loops):
    """Every in-range half-edge once under its target, a self-loop's
    only with ``loops`` (else counted in ``loops_left_out``)."""
    dist, src, dst, mask = _layout_case(groups, 50, seed=groups)
    n = dist.size
    lay = TO.minplus_layout(torch.from_numpy(src), torch.from_numpy(dst), n,
                            groups=groups, loops=loops)
    assert (lay.n_rows, lay.groups, lay.replicas) == (n, groups, 1)
    assert lay.local_bits == TO.MINPLUS_LOCAL_BITS
    assert lay.tile_rows == TO.minplus_tile_rows(n, lay.half_edges.shape[0])
    seen = _layout_rows(lay)
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    n_loops = int((ok & (src == dst)).sum())
    assert n_loops >= 30 * groups
    assert lay.loops_left_out == (0 if loops else n_loops)
    want = sorted([(d, s, e) for e, (s, d) in enumerate(zip(src, dst))
                   if ok[e] and (loops or s != d)]
                  + [(s, d, e) for e, (s, d) in enumerate(zip(src, dst))
                     if ok[e] and s != d])
    assert sorted((t, o, e) for t, o, e, *_ in seen) == want
    # each position once, the half-edge array sorted by (target, edge id)
    by_pos = sorted(seen, key=lambda r: r[4])
    assert [r[4] for r in by_pos] == list(range(len(want)))
    keys = [(t, e) for t, _, e, *_ in by_pos]
    assert keys == sorted(keys)
    deg = np.bincount([t for t, _, _ in want], minlength=n)
    for t, _, _, kind, _ in seen:
        assert kind == TO.minplus_row_kind(torch.tensor(deg[t])).item()
    # every kind occurs: the hubs (row 1 of each group), the long row 2
    assert set(lay.rows[: lay.counts[0], 0].tolist()) >= {
        k * 50 + 1 for k in range(groups)}
    assert {t for t, _, _, kind, _ in seen if kind in (1, 2)} >= {
        k * 50 + 2 for k in range(groups)}
    assert min(lay.counts) > 0


def test_minplus_layout_refuses_edges_across_groups():
    src = torch.tensor([0, 5], dtype=torch.int32)
    dst = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="two groups"):
        TO.minplus_layout(src, dst, 8, groups=2)


@pytest.mark.parametrize("rows,half_edges,want", [
    (5_073_280, 1_995_711, 2048),    # ETSCH's flat dblp state
    (317_080, 1_902_527, 256),       # the whole dblp graph
    (1000, 8_000, 256),              # 8 a row: the smallest
    (1000, 4_000, 512),
    (0, 0, 2048)])
def test_minplus_tile_rows(rows, half_edges, want):
    assert TO.minplus_tile_rows(rows, half_edges) == want


def _pull_over_layout(dist, mask, lay, cost):
    """The kernel's reading of the layout in numpy, in every replica: each
    tile pulls its short rows and writes every row but its others; each
    unit pulls and writes its row. Each row must be written exactly
    once."""
    he, units = lay.half_edges.numpy(), lay.rows.numpy()
    v, reps = lay.group_rows, lay.replicas
    bits, low = lay.local_bits, (1 << lay.local_bits) - 1
    out = np.full_like(dist, np.nan)
    writes = np.zeros(dist.size, int)

    def pull(off, lo, hi):
        o, e = he[lo:hi, 0], he[lo:hi, 1]
        c = np.where(mask[e], dist[off + o] + np.float32(cost), np.inf)
        return np.float32(c.min(initial=np.inf))

    for s in range(reps):
        for row0, shorts, others in _tiles(lay):
            off = (row0 // v * (reps - 1) + s) * v
            w = min(lay.tile_rows, v - row0 % v)
            cand = np.full(w, np.inf, np.float32)
            for first, word in shorts:
                cand[word & low] = pull(off, first, first + (word >> bits))
            keep = np.ones(w, bool)
            keep[others[:, 1] & low] = False
            rows = off + row0 + np.arange(w)[keep]
            out[rows] = np.where(cand[keep] < dist[rows], cand[keep],
                                 dist[rows])
            writes[rows] += 1
        for row, first, end, _ in units:
            off = (row // v * (reps - 1) + s) * v
            c = pull(off, first, end)
            out[off + row] = c if c < dist[off + row] else dist[off + row]
            writes[off + row] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cost", [1.0, 0.0, -1.0])
def test_minplus_pull_over_layout_matches_ref_and_pallas(small_classes,
                                                         groups, cost):
    """The pull over the layout is bit-identical to the plain scatter and
    to the Pallas kernel in interpret mode (on the in-range edges, which
    are all the Pallas kernel takes). A negative cost takes the layout
    with self-loops, as the wrapper does: without them it would differ."""
    dist, src, dst, mask = _layout_case(groups, 50, seed=10 + groups)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    lay = TO.minplus_layout(ts, td, dist.size, groups=groups,
                            loops=cost < 0)
    got = _pull_over_layout(dist, mask, lay, cost)
    without = _pull_over_layout(
        dist, mask, TO.minplus_layout(ts, td, dist.size, groups=groups),
        cost)
    assert np.array_equal(without, got) == (cost >= 0)
    ok = (src >= 0) & (src < dist.size) & (dst >= 0) & (dst < dist.size)
    args = [torch.from_numpy(a) for a in (dist, src[ok], dst[ok], mask[ok])]
    np.testing.assert_array_equal(got, TR.minplus_relax(*args, cost).numpy())
    jargs = [jnp.asarray(a) for a in (dist, src[ok], dst[ok], mask[ok])]
    pallas = RO.minplus_sweep(*jargs, cost=cost, block_v=128, block_e=256)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_minplus_replica_stride(small_classes):
    """With S replicas, layout row k·V + v stands for state row
    (k·S + s)·V + v: the pull equals S separate sweeps of each [K·V] slab
    picked out by that formula, and the wrapper's plain path on the
    replicated edge list."""
    k, v, reps, cost = 3, 40, 5, 1.0
    dist_kv, src, dst, mask = _layout_case(k, v, seed=7)
    ok = (src >= 0) & (src < k * v) & (dst >= 0) & (dst < k * v)
    src, dst, mask = src[ok], dst[ok], mask[ok]
    ts, td, tm = (torch.from_numpy(a) for a in (src, dst, mask))
    lay = TO.minplus_layout(ts, td, k * v, groups=k).with_replicas(reps)
    rng = np.random.default_rng(3)
    state = np.where(rng.random((k, reps, v)) < 0.4,
                     rng.random((k, reps, v)) * 9, np.inf).astype(np.float32)
    got = _pull_over_layout(state.reshape(-1), mask, lay, cost)
    want = np.empty_like(state)
    for s in range(reps):
        slab = torch.from_numpy(np.ascontiguousarray(state[:, s]).reshape(-1))
        want[:, s] = TR.minplus_relax(slab, ts, td, tm, cost).numpy().reshape(
            k, v)
    np.testing.assert_array_equal(got, want.reshape(-1))
    rs, rd, rm = lay.replicate(ts, td, tm)
    s_idx = np.repeat(np.arange(reps), src.size)
    s_all, d_all = np.tile(src, reps), np.tile(dst, reps)
    np.testing.assert_array_equal(
        rs.numpy(), (s_all // v * reps + s_idx) * v + s_all % v)
    np.testing.assert_array_equal(
        rd.numpy(), (d_all // v * reps + s_idx) * v + d_all % v)
    np.testing.assert_array_equal(rm.numpy(), np.tile(mask, reps))
    plain = _launches_unchanged(lambda: TO.minplus_sweep(
        torch.from_numpy(state.reshape(-1)), ts, td, tm, cost, layout=lay))
    np.testing.assert_array_equal(plain.numpy(), want.reshape(-1))


def test_minplus_sweep_with_layout_on_cpu():
    """A layout changes nothing on the CPU; one built from another edge
    list is refused."""
    dist, src, dst, mask = _sweep_case(200, 700, seed=4)
    args = [torch.from_numpy(a) for a in (dist, src, dst, mask)]
    lay = TO.minplus_layout(args[1], args[2], 200)
    assert torch.equal(TO.minplus_sweep(*args, layout=lay),
                       TO.minplus_sweep(*args))
    with pytest.raises(ValueError, match="another edge list"):
        TO.minplus_sweep(args[0], args[2], args[1], args[3], layout=lay)
