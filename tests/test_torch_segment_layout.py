"""repro_torch.engine.kernels.SegmentLayout: the per-plan layout that
``csrc/segment_reduce.cu`` walks. The CUDA kernel runs only on a card
(``tests/test_torch_gpu.py``); here a numpy walk over the layout, reading
it as the kernel reads it (tiles with their thread and warp runs, block
units, each target's append slots), is held against
``segment_reduce_ref`` and the JAX package's ``segment_reduce`` (Pallas in
interpret mode): min and max bit-identical, add within 1e-6 relative (the
same float32 terms summed in another order). The layout must hold every
live CSR and append slot once and give every target one writer."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import engine as E
from repro.core import baselines
from repro.core import graph as RG
from repro.engine import kernels as RK
from repro.stream.patch import EdgeChange, patch_plan
from repro_torch import engine as TE
from repro_torch.engine import kernels as TK

CPU = "cpu"
COMBINES = ("min", "max", "add")
ADD_RTOL = 1e-6
IDENT = {"min": np.inf, "max": -np.inf, "add": 0.0}


@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles, run kinds and gaps small enough for a test plan to hold
    all: a tile of 48 targets does not divide Vmax (a multiple of 128)."""
    for name, value in (("SEG_TILE_SLOTS", 64), ("SEG_TILE_TARGETS", 48),
                        ("SEG_THREAD", 2), ("SEG_WARP", 12), ("SEG_GAP", 4)):
        monkeypatch.setattr(TK, name, value)


def _patched(plan, g, owner, seed: int):
    """Deletions in the CSR prefix, inserts into the append region, some
    of them to vertices new to their partition (arrivals)."""
    rng = np.random.default_rng(seed)
    u, v = g.as_numpy()
    own = np.asarray(owner)[np.asarray(g.edge_mask)]
    dele = rng.choice(len(u), size=10, replace=False)
    changes = [EdgeChange(int(u[i]), int(v[i]), int(own[i]), -1)
               for i in dele]
    present = set(zip(u.tolist(), v.tolist()))
    while len(changes) < 10 + 40:
        a, b = sorted(rng.integers(0, g.n_vertices, 2).tolist())
        if a != b and (a, b) not in present:
            present.add((a, b))
            changes.append(EdgeChange(a, b, -1, int(rng.integers(0, plan.k))))
    return patch_plan(plan, changes)


@pytest.fixture(scope="module")
def plans():
    """name -> reference plan."""
    g = RG.largest_component(RG.barabasi_albert(300, 3, seed=3))
    owner = baselines.hash_partition(g, 4)
    slack = E.compile_plan(g, owner, 4, edge_slack=40, vertex_slack=16)
    patched = _patched(slack, g, owner, seed=1)
    assert int(np.asarray(patched.vmask).sum()) > \
        int(np.asarray(slack.vmask).sum())            # arrived vertices
    # a hub-heavy power-law plan: two stars over a BA graph
    ba = RG.barabasi_albert(400, 2, seed=4)
    u, v = ba.as_numpy()
    stars = [(0, x) for x in range(1, 400, 2)] + [(7, x) for x in
                                                   range(8, 400, 3)]
    edges = np.unique(np.sort(np.concatenate(
        [np.stack([u, v], 1), np.array(stars)]), 1), axis=0)
    hubs = RG.from_edge_array(400, edges[edges[:, 0] != edges[:, 1]])
    return {"fresh": E.compile_plan(g, owner, 4),
            "patched": patched,
            "hubs": E.compile_plan(hubs, baselines.hash_partition(hubs, 2),
                                   2),
            # partition 2 owns no edge
            "empty_part": E.compile_plan(g, baselines.hash_partition(g, 2),
                                         3)}


def _messages(plan, features: int, combine: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = tuple(plan.emask.shape) + ((features,) if features > 1 else ())
    m = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    if combine == "min":
        m[rng.random(shape) < 0.1] = np.inf          # unreached (SSSP)
    if combine == "add":
        m = (m / 100).astype(np.float32)             # rank/degree-sized
    return m


def _runs(plan):
    """[K, Vmax, 2] each target's CSR run [start, end) as the scan picks
    it: the nearest segment start at or before ``last_slot`` up to
    ``min(last_slot, csr_fill - 1)``; [0, 0) where empty or ``!vmask``
    (found by walking back, not through ``run_start``)."""
    seg = np.asarray(plan.seg_start)
    last = np.asarray(plan.last_slot)
    vmask = np.asarray(plan.vmask)
    fill = np.asarray(plan.csr_fill)
    out = np.zeros(last.shape + (2,), np.int64)
    for k in range(plan.k):
        for v in range(plan.v_max):
            lst = int(last[k, v])
            hi = min(lst, int(fill[k]) - 1)
            if not vmask[k, v] or hi < 0:
                continue
            s = lst
            while s > 0 and not seg[k, s]:
                s -= 1
            if s <= hi:
                out[k, v] = (s, hi + 1)
    return out


def _append(plan):
    """target -> its live append slots, by slot (flat ids)."""
    emask = np.asarray(plan.emask)
    tgt = np.asarray(plan.edge_tgt)
    vmask = np.asarray(plan.vmask)
    fill = np.asarray(plan.csr_fill)
    out = {}
    for k in range(plan.k):
        for s in range(int(fill[k]), plan.e_max):
            t = int(tgt[k, s])
            if emask[k, s] and 0 <= t < plan.v_max and vmask[k, t]:
                out.setdefault(k * plan.v_max + t, []).append(
                    k * plan.e_max + s)
    return out


def _walk(lay, plan, msgs, combine):
    """The kernel's reading of the layout in numpy: every tile reduces the
    runs of its targets from its window (a thread's up to ``thread_max``
    slots in slot order, a warp's listed runs) and skips its units'
    targets; every unit reduces its run; each writer then combines its
    target's append slots in order. Each target must be written once."""
    op = {"min": np.minimum, "max": np.maximum, "add": np.add}[combine]
    ident = np.float32(IDENT[combine])
    f = 1 if msgs.ndim == 2 else msgs.shape[2]
    m = np.where(np.asarray(plan.emask)[:, :, None],
                 msgs.reshape(plan.k, plan.e_max, f), ident)
    m = m.reshape(-1, f).astype(np.float32)
    tiles, words = lay.tiles.numpy(), lay.words.numpy()
    warps, units = lay.warp_targets.numpy(), lay.units.numpy()
    app_ptr, app = lay.app_ptr.numpy(), lay.app_slots.numpy()
    out = np.full((plan.k * plan.v_max, f), np.nan, np.float32)
    writes = np.zeros(plan.k * plan.v_max, int)

    def reduce(slots, acc=None):
        acc = np.full(f, ident, np.float32) if acc is None else acc
        for s in slots:
            acc = op(acc, m[s]).astype(np.float32)
        return acc

    def write(t, acc):
        if lay.n_append:
            acc = reduce(app[app_ptr[t]:app_ptr[t + 1]], acc)
        out[t] = acc
        writes[t] += 1

    for t0, n, s0, w, wf, we, af, ae in tiles:
        assert s0 % 16 == 0 and w >= 0 and n <= lay.tile_targets
        assert w <= lay.window_cap
        warp_set = set(warps[wf:we].tolist())
        assert all(t0 <= t < t0 + n for t in warp_set)
        if lay.n_append:
            assert (af, ae) == (app_ptr[t0], app_ptr[t0 + n])
        for t in range(t0, t0 + n):
            off, length = words[t] & 0xFFFF, words[t] >> 16
            if length == TK.SEG_UNIT:
                assert t not in warp_set
                continue
            assert (t in warp_set) == (length > lay.thread_max)
            assert off + length <= w
            write(t, reduce(range(s0 + off, s0 + off + length)))
    assert (np.diff(units[:, 2]) <= 0).all()          # longest first
    for t, s0, length, _ in units:
        assert words[t] >> 16 == TK.SEG_UNIT
        write(t, reduce(range(s0, s0 + length)))
    assert (writes == 1).all()
    out = out.reshape(plan.k, plan.v_max, f)
    return out[:, :, 0] if msgs.ndim == 2 else out


def test_layout_covers_every_live_slot_once(small_tiles, plans):
    """Every slot of a live target's run is in exactly one tile run or
    unit, under its target; every live append slot once, under its
    target; every target in exactly one tile; every kind occurs."""
    seen_kinds = set()
    for name, ref in plans.items():
        plan = TE.plan_from_numpy(ref, device=CPU)
        lay = TK.build_segment_layout(plan)
        runs = _runs(ref).reshape(-1, 2)
        tiles, words = lay.tiles.numpy(), lay.words.numpy()
        owner_of = {}                      # flat slot -> target
        in_tile = np.zeros(plan.k * plan.v_max, int)
        for t0, n, s0, _, *_ in tiles:
            in_tile[t0:t0 + n] += 1
            for t in range(t0, t0 + n):
                off, length = words[t] & 0xFFFF, words[t] >> 16
                if length != TK.SEG_UNIT:
                    for s in range(s0 + off, s0 + off + length):
                        assert s not in owner_of
                        owner_of[s] = t
                    seen_kinds.add("thread" if length <= lay.thread_max
                                   else "warp")
        for t, s0, length, _ in lay.units.numpy():
            for s in range(s0, s0 + length):
                assert s not in owner_of
                owner_of[s] = t
            seen_kinds.add("block")
        assert (in_tile == 1).all()
        want = {t // plan.v_max * plan.e_max + s: t
                for t, (a, b) in enumerate(runs) for s in range(a, b)}
        assert owner_of == want, name
        app = _append(ref)
        ptr, slots = lay.app_ptr.numpy(), lay.app_slots.numpy()
        assert lay.n_append == sum(map(len, app.values()))
        if app:
            got = {t: slots[ptr[t]:ptr[t + 1]].tolist()
                   for t in range(plan.k * plan.v_max) if ptr[t + 1] > ptr[t]}
            assert got == app
        else:
            assert ptr.tolist() == [0]
        if name == "patched":
            assert lay.n_append > 0
        if name == "empty_part":
            assert not runs.reshape(plan.k, plan.v_max, 2)[2].any()
    assert seen_kinds == {"thread", "warp", "block"}


@pytest.mark.parametrize("features", [1, 3])
@pytest.mark.parametrize("name", ["fresh", "patched", "hubs", "empty_part"])
def test_layout_walk_matches_plain_and_reference(small_tiles, plans, name,
                                                 features):
    ref = plans[name]
    plan = TE.plan_from_numpy(ref, device=CPU)
    lay = TK.build_segment_layout(plan)
    for i, combine in enumerate(COMBINES):
        m = _messages(plan, features, combine, seed=features * 10 + i)
        got = _walk(lay, plan, m, combine)
        plain = TK.segment_reduce_ref(plan, torch.from_numpy(m),
                                      combine).numpy()
        pallas = np.asarray(RK.segment_reduce(ref, jnp.asarray(m), combine))
        assert got.shape == plain.shape == pallas.shape
        if combine == "add":
            for want in (plain, pallas):
                np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, plain)
            np.testing.assert_array_equal(got, pallas)


def test_default_layout_walk_matches_plain(plans):
    """The shipped thresholds on the hub plan: every target a tile's
    (no run there exceeds SEG_WARP), one tile per partition block of
    SEG_TILE_TARGETS targets or less."""
    plan = TE.plan_from_numpy(plans["hubs"], device=CPU)
    lay = TK.build_segment_layout(plan)
    assert lay.n_units == 0 and lay.thread_max == TK.SEG_THREAD
    assert lay.window_cap <= TK.SEG_TILE_SLOTS + TK.SEG_WARP + 32
    m = _messages(plan, 1, "min", seed=5)
    np.testing.assert_array_equal(
        _walk(lay, plan, m, "min"),
        TK.segment_reduce_ref(plan, torch.from_numpy(m), "min").numpy())


def test_out_of_order_runs_become_units(small_tiles):
    """A plan whose CSR runs are not in target order (never compiled, but
    the kernel's semantics allow it): target 1's run lies before target
    0's, so target 1 is a unit; the walk equals the scan and the
    scatter."""
    k, e_max, v_max = 1, 16, 8
    tgt = np.array([1, 1, 1, 0, 0, 2] + [0] * 10, np.int32)
    seg = np.zeros((k, e_max), bool)
    seg[0, [0, 3, 5, 6]] = True
    emask = np.zeros((k, e_max), bool)
    emask[0, :6] = True
    last = np.full((k, v_max), e_max - 1, np.int32)
    last[0, :3] = [4, 2, 5]
    vmask = np.zeros((k, v_max), bool)
    vmask[0, :3] = True
    fields = dict(
        k=k, n_vertices=3, v_max=v_max, e_max=e_max, epoch=0, e_slots=6,
        local2global=np.arange(v_max, dtype=np.int32)[None] % 3,
        vmask=vmask, edge_tgt=tgt[None], edge_nbr=np.zeros((k, e_max),
                                                           np.int32),
        emask=emask, seg_start=seg, last_slot=last,
        replicated=np.zeros((k, v_max), bool),
        is_master=vmask.copy(), n_local=np.array([3], np.int32),
        n_edges_local=np.array([3], np.int32),
        n_replicated=np.zeros(1, np.int32), csr_fill=np.array([6], np.int32),
        v_fill=np.array([3], np.int32), edge_w=np.ones((k, e_max),
                                                       np.float32),
        edge_slot=np.full((k, e_max), -1, np.int32))
    plan = TE.plan_from_numpy(fields, device=CPU)
    lay = TK.build_segment_layout(plan)
    assert lay.units[:, 0].tolist() == [1] and lay.n_units == 1
    ref = types.SimpleNamespace(**{n: jnp.asarray(fields[n]) for n in (
        "csr_fill", "emask", "seg_start", "last_slot", "edge_tgt",
        "vmask")})
    for combine in COMBINES:
        m = _messages(plan, 1, combine, seed=3)
        got = _walk(lay, plan, m, combine)
        np.testing.assert_allclose(
            got, TK.segment_reduce_ref(plan, torch.from_numpy(m),
                                       combine).numpy(), rtol=ADD_RTOL)
        np.testing.assert_allclose(
            got, np.asarray(RK.segment_reduce(ref, jnp.asarray(m), combine)),
            rtol=ADD_RTOL)


def test_layout_is_memoised_per_plan(plans, monkeypatch):
    """Built once per plan instance (at its first call where the plan is on
    the CPU); a ``dataclasses.replace``d plan builds its own."""
    plan = TE.plan_from_numpy(plans["patched"], device=CPU)
    assert "_segment_layout" not in plan.__dict__   # only a card plan's
    built = []
    real = TK.build_segment_layout
    monkeypatch.setattr(TK, "build_segment_layout",
                        lambda p: built.append(p) or real(p))
    lay = TK.segment_layout(plan)
    assert TK.segment_layout(plan) is lay and built == [plan]
    other = dataclasses.replace(plan, emask=plan.emask.clone())
    assert TK.segment_layout(other) is not lay
    assert built == [plan, other]
    assert TK.segment_layout(plan) is lay


def test_layout_checks_plan_fields():
    """A plan field of the wrong dtype raises before anything is built."""
    g = RG.largest_component(RG.barabasi_albert(60, 2, seed=0))
    plan = TE.plan_from_numpy(E.compile_plan(g, baselines.hash_partition(
        g, 2), 2), device=CPU)
    bad = dataclasses.replace(plan, last_slot=plan.last_slot.long())
    with pytest.raises(ValueError, match="last_slot"):
        TK.build_segment_layout(bad)
