"""repro_torch.engine.kernels.GspmmLayout: the per-plan reading of the
segment layout that ``csrc/gspmm.cu`` walks. The CUDA kernel runs only on
a card (``tests/test_torch_gpu.py``); here a numpy walk reads the layout
exactly as the kernel does (each tile's window split evenly over its lane
groups, a run that crosses a group's end finished by the group that began
it with the next groups' partials in order, a target without a run
written as the identity; the units cut into chunks, each combined by the
block (groups striding its slots, then a warp's groups by shuffles and
the warps in order), the chunks' partial rows in chunk order; each
target's append slots pulled by its writer) and is held against
``gspmm_ref`` and the JAX package's ``gspmm`` (Pallas in interpret mode):
max bit-identical, add and mean within 1e-5 relative (the same float32
products summed in another order, on non-negative inputs)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import kernels as RK
from repro_torch import engine as TE
from repro_torch.engine import kernels as TK

from test_torch_gpu import _wider
from test_torch_segment_layout import plans  # noqa: F401  (fixture)

CPU = "cpu"
RTOL = 1e-5
IDENT = {"min": np.inf, "max": -np.inf, "add": 0.0}
OPS = {"min": np.minimum, "max": np.maximum, "add": np.add}
#: csrc/gspmm.cu's threads a block and lanes a warp.
THREADS, WARP = 256, 32


@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles, run kinds and gaps small enough for a test plan to hold all
    (as tests/test_torch_segment_layout.py), and unit chunks of 5 slots,
    so that every unit of more than 5 slots is split."""
    for name, value in (("SEG_TILE_SLOTS", 64), ("SEG_TILE_TARGETS", 48),
                        ("SEG_THREAD", 2), ("SEG_WARP", 12), ("SEG_GAP", 4),
                        ("GS_CHUNK", 5)):
        monkeypatch.setattr(TK, name, value)


def _inputs(plan, features: int, per_feature: bool, seed: int):
    """Non-negative feats [K, Vmax(, F)] (rank 2 at F = 1) and weights
    [K, Emax(, F)], numpy float32."""
    rng = np.random.default_rng(seed)
    shape = (plan.k, plan.v_max) + ((features,) if features > 1 else ())
    feats = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    w = rng.uniform(0.0, 2.0, tuple(plan.emask.shape) + (
        (features,) if per_feature else ())).astype(np.float32)
    return feats, w


def _walk(lay, plan, feats, w, combine, lanes):
    """The kernel's reading of ``lay`` in numpy, for ``lanes`` lanes a
    slot (``THREADS // lanes`` groups a block). Returns [K, Vmax, F]; each
    target must be written once."""
    op, ident = OPS[combine], np.float32(IDENT[combine])
    seg = lay.seg
    k, e_max, v_max = plan.k, plan.e_max, plan.v_max
    f3 = feats.reshape(k * v_max, -1)
    f = f3.shape[1]
    nbr = plan.edge_nbr.numpy().reshape(-1)
    emask = plan.emask.numpy().reshape(-1)
    w2 = w.reshape(k * e_max, -1)
    n_groups = THREADS // lanes

    def x(s):
        """The weighted row of live flat slot s (one rounding)."""
        row = s // e_max * v_max + min(max(int(nbr[s]), 0), v_max - 1)
        return (f3[row] * w2[s]).astype(np.float32)

    def comb(a, b):
        return op(a, b).astype(np.float32)

    def in_order(slots):
        acc = np.full(f, ident, np.float32)
        for s in slots:
            if emask[s]:
                acc = comb(acc, x(s))
        return acc

    def block(s0, length):
        """The block's combine of flat slots s0 .. s0 + length - 1."""
        group = [in_order(range(s0 + g, s0 + length, n_groups))
                 for g in range(n_groups)]
        per_warp = WARP // lanes            # the shuffles of a warp
        rows = []
        for wi in range(THREADS // WARP):
            vals = group[wi * per_warp:(wi + 1) * per_warp]
            o = 1
            while o < per_warp:
                vals = [comb(vals[i], vals[i ^ o]) for i in range(per_warp)]
                o *= 2
            rows.append(vals[0])
        acc = rows[0]
        for row in rows[1:]:                # the warps in order
            acc = comb(acc, row)
        return acc

    app_ptr, app = seg.app_ptr.numpy(), seg.app_slots.numpy()
    out = np.full((k * v_max, f), np.nan, np.float32)
    writes = np.zeros(k * v_max, int)

    def finish(t, acc):
        if seg.n_append:
            for s in app[app_ptr[t]:app_ptr[t + 1]]:
                acc = comb(acc, x(int(s)))
        out[t] = acc
        writes[t] += 1

    words = seg.words.numpy()
    slot_targets = lay.slot_targets.numpy()
    for t0, n, s0, width, _, _, _, _ in seg.tiles.numpy():
        tgt = slot_targets[s0:s0 + width].astype(int) - t0   # as staged
        tgt[(tgt < 0) | (tgt >= n)] = -1
        staged = 0
        for i in range(n):
            off, length = words[t0 + i] & 0xFFFF, words[t0 + i] >> 16
            if length == 0:
                finish(t0 + i, np.full(f, ident, np.float32))
            elif length != TK.SEG_UNIT:
                assert (tgt[off:off + length] == i).all()
                staged += length
        assert (tgt >= 0).sum() == staged
        per = -(-width // n_groups)
        heads, pending = {}, []
        for g in range(n_groups):
            lo, hi = min(width, g * per), min(width, g * per + per)
            first = tgt[lo] if lo < hi else -1
            cont = first >= 0 and lo > 0 and tgt[lo - 1] == first
            cur, acc = -1, None
            for s in range(lo, hi):
                if tgt[s] != cur:
                    if cur >= 0:
                        if cur == first and cont:
                            heads[g] = (cur, acc)
                        else:
                            finish(t0 + cur, acc)
                    cur, acc = tgt[s], np.full(f, ident, np.float32)
                if cur >= 0 and emask[s0 + s]:
                    acc = comb(acc, x(s0 + s))
            if cur >= 0:
                if cur == first and cont:
                    heads[g] = (cur, acc)
                elif hi < width and tgt[hi] == cur:
                    pending.append((g, cur, acc))
                else:
                    finish(t0 + cur, acc)
        for g, cur, acc in pending:         # after the block's barrier
            h = g + 1
            while h in heads and heads[h][0] == cur:
                acc = comb(acc, heads[h][1])
                h += 1
            finish(t0 + cur, acc)

    chunks = lay.chunks.numpy()
    units = seg.units.numpy()
    assert lay.counters.numpy().tolist() == [0] * seg.n_units
    partials = {}
    for b, (t, c0, length, u, first, n_chunks, _, _) in enumerate(chunks):
        assert units[u][0] == t and first <= b < first + n_chunks
        assert words[t] >> 16 == TK.SEG_UNIT
        assert c0 == units[u][1] + (b - first) * lay.chunk_slots
        assert length <= lay.window_cap
        if n_chunks == 1:
            finish(t, block(c0, length))
            continue
        partials[b] = block(c0, length)
        if b == first + n_chunks - 1:       # all chunks of the unit in
            acc = partials[first]
            for c in range(first + 1, first + n_chunks):
                acc = comb(acc, partials[c])
            finish(t, acc)
    assert (writes == 1).all()
    return out.reshape(k, v_max, f)


def _held(got, plan, ref, feats, w, combine):
    """got against gspmm_ref and the JAX package's gspmm."""
    tf, tw = torch.from_numpy(feats), torch.from_numpy(w)
    plain = TK.gspmm_ref(plan, tf, tw, combine).numpy()
    pallas = np.asarray(RK.gspmm(ref, jnp.asarray(feats), jnp.asarray(w),
                                 combine))
    assert got.shape == plain.shape == pallas.shape
    for want in (plain, pallas):
        if combine == "max":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _mean(plan, total):
    count = TK.segment_reduce_ref(
        plan, torch.ones(plan.emask.shape), "add").clamp(min=1.0).numpy()
    return (total / count[:, :, None]).astype(np.float32)


@pytest.mark.parametrize("per_feature", [False, True],
                         ids=["scalar_w", "feature_w"])
@pytest.mark.parametrize("features", [1, 3, 8])
@pytest.mark.parametrize("name", ["fresh", "patched", "hubs", "empty_part"])
def test_gspmm_walk_matches_plain_and_reference(small_tiles, plans, name,
                                                features, per_feature):
    """Every run kind, split units and append slots, at the lanes
    gspmm_mapping gives F (aligned planes)."""
    ref = plans[name]
    plan = TE.plan_from_numpy(ref, device=CPU)
    lay = TK.build_gspmm_layout(plan)
    lanes = TK.gspmm_mapping(features, features % 4 == 0)[0]
    feats, w = _inputs(plan, features, per_feature,
                       seed=features + 10 * per_feature)
    for combine in ("add", "max"):
        got = _walk(lay, plan, feats, w, combine, lanes)
        _held(got, plan, ref, feats, w, combine)
    _held(_mean(plan, _walk(lay, plan, feats, w, "add", lanes)), plan, ref,
          feats, w, "mean")
    if name == "hubs":
        assert lay.split and lay.seg.n_units > 0
    if name == "patched":
        assert lay.seg.n_append > 0


@pytest.mark.parametrize("per_feature", [False, True],
                         ids=["scalar_w", "feature_w"])
@pytest.mark.parametrize("name", ["fresh", "patched", "hubs"])
def test_gspmm_walk_with_unaligned_e_max(small_tiles, plans, name,
                                         per_feature):
    """A plan widened by two dead slots a partition (Emax % 4 == 2, where
    the kernel stages a slot at a time): its layout, walked at F = 8,
    gives the plain and reference results of the plan it was widened
    from."""
    ref = plans[name]
    base = TE.plan_from_numpy(ref, device=CPU)
    plan = _wider(base, 2)
    assert plan.e_max % 4 == 2
    lay = TK.build_gspmm_layout(plan)
    feats, w = _inputs(base, 8, per_feature, seed=3 + per_feature)
    w_wide = np.concatenate([w, w[:, :2]], 1)
    for combine in ("add", "max"):
        got = _walk(lay, plan, feats, w_wide, combine, 2)
        _held(got, base, ref, feats, w, combine)


@pytest.mark.parametrize("features", [1, 8, 128])
def test_gspmm_walk_with_default_layout(plans, features):
    """The shipped thresholds on the hub plan: windows of hundreds of
    slots, so a group walks several runs, at F = 128 (8 groups a block)
    too."""
    ref = plans["hubs"]
    plan = TE.plan_from_numpy(ref, device=CPU)
    lay = TK.build_gspmm_layout(plan)
    assert lay.chunk_slots == TK.GS_CHUNK and lay.seg.window_cap > 256
    lanes = TK.gspmm_mapping(features, True)[0]
    feats, w = _inputs(plan, features, False, seed=7)
    got = _walk(lay, plan, feats, w, "add", lanes)
    np.testing.assert_allclose(
        got, TK.gspmm_ref(plan, torch.from_numpy(feats), torch.from_numpy(w),
                          "add").numpy(), rtol=RTOL, atol=0)


def test_slot_targets_mark_every_staged_slot(small_tiles, plans):
    """Each slot of a thread's or a warp's run holds its target; every
    other slot of the stream holds -1."""
    for name, ref in plans.items():
        plan = TE.plan_from_numpy(ref, device=CPU)
        lay = TK.build_gspmm_layout(plan)
        seg = lay.seg
        want = np.full(plan.k * plan.e_max, -1)
        words = seg.words.numpy()
        for t0, n, s0, *_ in seg.tiles.numpy():
            for i in range(n):
                off, length = words[t0 + i] & 0xFFFF, words[t0 + i] >> 16
                if length != TK.SEG_UNIT:
                    want[s0 + off:s0 + off + length] = t0 + i
        assert lay.slot_targets.dtype == torch.int32
        np.testing.assert_array_equal(lay.slot_targets.numpy(), want,
                                      err_msg=name)


def test_chunks_cover_every_unit_slot_once(small_tiles, plans):
    """Each unit's slots are its chunks', in order, chunk_slots a chunk
    but the last; units keep their longest-first order; every unit of
    more than one chunk is counted by ``split``."""
    for name, ref in plans.items():
        plan = TE.plan_from_numpy(ref, device=CPU)
        lay = TK.build_gspmm_layout(plan)
        units, chunks = lay.seg.units.numpy(), lay.chunks.numpy()
        b = 0
        for u, (t, s0, length, _) in enumerate(units):
            n = -(-length // TK.GS_CHUNK)
            rows = chunks[b:b + n]
            assert (rows[:, 0] == t).all() and (rows[:, 3] == u).all()
            assert (rows[:, 4] == b).all() and (rows[:, 5] == n).all()
            assert rows[:, 1].tolist() == list(range(s0, s0 + length,
                                                     TK.GS_CHUNK))
            assert rows[:, 2].sum() == length
            assert (rows[:-1, 2] == TK.GS_CHUNK).all()
            b += n
        assert b == lay.n_chunks, name
        assert lay.split == any(-(-length // TK.GS_CHUNK) > 1
                                for length in units[:, 2])
        assert lay.counters.dtype == torch.int32
        assert lay.counters.shape == (lay.seg.n_units,)


def test_gspmm_layout_is_memoised_per_plan(plans, monkeypatch):
    """Built once per plan instance over the plan's own segment layout (at
    its first call where the plan is on the CPU); a
    ``dataclasses.replace``d plan builds its own."""
    plan = TE.plan_from_numpy(plans["hubs"], device=CPU)
    assert "_gspmm_layout" not in plan.__dict__      # only a card plan's
    built = []
    real = TK.build_gspmm_layout
    monkeypatch.setattr(TK, "build_gspmm_layout",
                        lambda p: built.append(p) or real(p))
    lay = TK.gspmm_layout(plan)
    assert TK.gspmm_layout(plan) is lay and built == [plan]
    assert lay.seg is TK.segment_layout(plan)
    other = dataclasses.replace(plan, emask=plan.emask.clone())
    assert TK.gspmm_layout(other) is not lay and built == [plan, other]


@pytest.mark.parametrize("features,vec4,want", [
    (1, False, (1, 1)), (3, False, (4, 1)), (8, True, (2, 4)),
    (8, False, (8, 1)), (40, True, (16, 4)), (128, True, (32, 4)),
    (512, True, (32, 4))])
def test_gspmm_mapping(features, vec4, want):
    """Lanes a slot and floats a load: one pass up to lanes·vec features
    (more passes past a warp's), 16-byte loads only for aligned planes."""
    assert TK.gspmm_mapping(features, vec4) == want
    lanes, vec = want
    assert THREADS % lanes == 0 and WARP % lanes == 0
    assert lanes * vec >= min(features, 128)
