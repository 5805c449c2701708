"""Batched and warm-started dispatch of the port against the JAX package:
``Engine.run_batched`` / ``multi_source_sssp`` for sssp, bfs and wsssp and
a user-registered program with an edge channel, held lane by lane against
the reference's ``run_batched`` (its vmapped XLA path), under superstep
and local-iteration caps and warm blocks with +inf rows: states bit for
bit, per-lane ``supersteps``, ``local_iters`` and ``converged`` equal.
Also ``Engine.with_plan``, the plan cache and ``edge_slot_hwm`` against
the reference's. Plans are carried across with ``plan_from_numpy``."""
import numpy as np
import pytest
import torch

from repro import engine as E
from repro.core import baselines
from repro.core import graph as RG
from repro.core.graph import edge_weights
from repro.stream.patch import EdgeChange, patch_plan
from repro_torch import engine as TE
from repro_torch.core import graph as TG

CPU = "cpu"
#: barabasi_albert(150, 3, seed=5) plus vertex 150, which has no edge and
#: so lives in no partition.
N_VERTICES = 151
#: Lanes: a duplicate (7) and the vertex in no partition (150).
SOURCES = np.array([0, 7, 150, 42, 7, 149], np.int32)
#: The plans: K=3 without slack, K=4 with edge_slack=8.
PLANS = {"k3": (3, 0), "k4-slack8": (4, 8)}
PROGRAMS = ("sssp", "bfs", "wsssp")
CAPS = {"default": {}, "steps0": {"max_supersteps": 0},
        "steps1": {"max_supersteps": 1}, "steps3": {"max_supersteps": 3},
        "local1": {"max_local_iters": 1}, "local2": {"max_local_iters": 2}}
#: Rows of a warm block set to +inf: those lanes start cold.
COLD_ROWS = [1, 3]


def _graph():
    u, v = RG.barabasi_albert(150, 3, seed=5).as_numpy()
    return RG.from_edge_array(N_VERTICES, np.stack([u, v], 1))


@pytest.fixture(scope="module")
def engines():
    """plan name -> (reference engine, port engine)."""
    g = _graph()
    out = {}
    for name, (k, slack) in PLANS.items():
        plan = E.compile_plan(g, baselines.hash_partition(g, k), k,
                              edge_slack=slack)
        out[name] = (E.Engine(plan),
                     TE.Engine(TE.plan_from_numpy(plan, device=CPU)))
    return out


def _programs(name: str):
    return (E.get_program(name).program, TE.get_program(name).program)


def _same(ref, port, lanes: int = len(SOURCES)) -> None:
    """Lane by lane: state bit for bit, counters equal."""
    assert tuple(port.state.shape) == (lanes, N_VERTICES)
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))
    for field in ("supersteps", "local_iters", "converged"):
        got = getattr(port, field)
        assert tuple(got.shape) == (lanes,), field
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, field)), field)
    assert port.row() == ref.row()


@pytest.mark.parametrize("caps", CAPS, ids=str)
@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("plan", PLANS)
def test_run_batched_matches_reference(engines, plan, program, caps):
    eng, teng = engines[plan]
    prog, tprog = _programs(program)
    ref = eng.run_batched(prog, {"source": SOURCES}, **CAPS[caps])
    port = teng.run_batched(tprog, {"source": SOURCES}, **CAPS[caps])
    _same(ref, port)


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("plan", PLANS)
def test_lanes_equal_solo_runs(engines, plan, program):
    """Each lane of the port's batch is the port's own solo run of it."""
    _, teng = engines[plan]
    _, tprog = _programs(program)
    for caps in ({}, {"max_supersteps": 1}, {"max_local_iters": 1}):
        batch = teng.run_batched(tprog, {"source": SOURCES}, **caps)
        for i, s in enumerate(SOURCES):
            solo = teng.run(tprog, source=int(s), **caps)
            assert torch.equal(batch.state[i], solo.state), (i, caps)
            assert (int(batch.supersteps[i]), int(batch.local_iters[i]),
                    bool(batch.converged[i])) == (
                solo.supersteps, solo.local_iters, solo.converged)


@pytest.mark.parametrize("local", [None, 1], ids=["default", "local1"])
@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("plan", PLANS)
def test_warm_block_matches_reference(engines, plan, program, local):
    """A [S, V] warm block from a one-superstep batch, two rows +inf (their
    lanes start cold)."""
    eng, teng = engines[plan]
    prog, tprog = _programs(program)
    block = np.array(eng.run_batched(prog, {"source": SOURCES},
                                     max_supersteps=1).state)
    block[COLD_ROWS] = np.inf
    caps = {} if local is None else {"max_local_iters": local}
    ref = eng.run_batched(prog, {"source": SOURCES}, warm_state=block,
                          **caps)
    port = teng.run_batched(tprog, {"source": SOURCES}, warm_state=block,
                            **caps)
    _same(ref, port)
    cold = teng.run_batched(tprog, {"source": SOURCES}, **caps)
    for i in COLD_ROWS:
        assert torch.equal(port.state[i], cold.state[i])
        assert int(port.supersteps[i]) == int(cold.supersteps[i])


@pytest.mark.parametrize("plan", PLANS)
def test_multi_source_sssp_matches_reference(engines, plan):
    eng, teng = engines[plan]
    _same(E.multi_source_sssp(eng, SOURCES),
          TE.multi_source_sssp(teng, SOURCES))


def test_batched_warm_state_shape_is_checked(engines):
    eng, teng = engines["k3"]
    src = np.array([0, 1], np.int32)
    with pytest.raises(TE.WarmStateError, match="expected"):
        teng.run_batched(TE.SSSP, {"source": src},
                         warm_state=np.zeros(N_VERTICES))
    with pytest.raises(TE.WarmStateError, match="no warm_init hook"):
        teng.run_batched(TE.WCC, {"source": src},
                         warm_state=np.zeros((2, N_VERTICES)))
    with pytest.raises(E.WarmStateError):
        eng.run_batched(E.SSSP, {"source": src},
                        warm_state=np.zeros(N_VERTICES))


def test_gspmm_programs_take_no_lanes(engines):
    """No registered program is both batchable and on the gspmm path;
    batching one raises a typed error instead of running lanes through a
    kernel that has none."""
    _, teng = engines["k3"]
    with pytest.raises(TE.BatchAxisError, match="gspmm"):
        teng.dispatch_batched(TE.GCN_LAYER, {"x": np.zeros((2, 1))})
    with pytest.raises(TE.BatchAxisError, match="lane"):
        teng.dispatch_batched(TE.SSSP, {"source": np.zeros(0, np.int32)})


# ---------------------------------------------------------------------------
# a user-registered batchable program with an edge channel
# ---------------------------------------------------------------------------

def _cwsssp_reference():
    """Channel-weighted SSSP (``tests/test_registry.py``'s worked example):
    weights arrive as an edge property plane in graph slot order."""
    import jax.numpy as jnp
    inf = jnp.float32(jnp.inf)

    def prepare(plan, kw):
        return {"source": kw["source"],
                "w": E.gather_edge_channel(plan, kw["weights"])[:, :, 0]}

    def init(plan, ctx):
        hit = plan.vmask & (plan.local2global == ctx["source"])
        return jnp.where(hit, 0.0, inf)

    def fin(glob, present, plan, ctx):
        iota = jnp.arange(plan.n_vertices)
        return jnp.where(present, glob,
                         jnp.where(iota == ctx["source"], 0.0, inf))

    return E.EdgeProgram(
        name="cwsssp", mode="replica", combine="min", prepare=prepare,
        init=init, pre=lambda s, c: s, apply=lambda o, a, c: jnp.minimum(o, a),
        finalize=fin, local_fixpoint=True,
        edge=lambda m, plan, ctx: m + ctx["w"])


def _cwsssp_port():
    """The same program written for the port, one query's tensors."""
    inf = float("inf")

    def prepare(plan, kw):
        return {"source": kw["source"],
                "w": TE.gather_edge_channel(plan, kw["weights"])[:, :, 0]}

    def init(plan, ctx):
        hit = plan.vmask & (plan.local2global == ctx["source"])
        return torch.where(hit, 0.0, inf)

    def fin(glob, present, plan, ctx):
        iota = torch.arange(plan.n_vertices, device=glob.device)
        return torch.where(present, glob,
                           torch.where(iota == ctx["source"], 0.0, inf))

    return TE.EdgeProgram(
        name="cwsssp", mode="replica", combine="min", prepare=prepare,
        init=init, pre=lambda s, c: s, apply=lambda o, a, c: torch.minimum(o, a),
        finalize=fin, local_fixpoint=True,
        edge=lambda m, plan, ctx: m + ctx["w"])


@pytest.fixture
def cwsssp():
    """(reference entry, port entry), registered through the public API."""
    entries = []
    for mod, prog in ((E, _cwsssp_reference()), (TE, _cwsssp_port())):
        entries.append(mod.register("cwsssp", prog, params=[
            mod.ParamSpec("source", int, batchable=True),
            mod.ParamSpec("weights", float, role="channel",
                          channel="edge")]))
    yield entries
    E.unregister("cwsssp")
    TE.unregister("cwsssp")


@pytest.mark.parametrize("caps", ["default", "steps1", "local1"])
@pytest.mark.parametrize("plan", PLANS)
def test_user_program_with_edge_channel_batches(engines, cwsssp, plan, caps):
    eng, teng = engines[plan]
    ref_entry, port_entry = cwsssp
    g = _graph()
    u, v = g.as_numpy()
    w = np.zeros(g.e_pad, np.float32)
    w[np.asarray(g.edge_mask)] = edge_weights(u, v)
    w = w * np.random.default_rng(3).integers(1, 4, g.e_pad)
    params = {"source": 0, "weights": w}
    ref_kw = ref_entry.channel_args(ref_entry.normalize(params), eng.plan)
    port_kw = port_entry.channel_args(port_entry.normalize(params),
                                      teng.plan)
    ref = eng.run_batched(ref_entry.program, {"source": SOURCES},
                          **CAPS[caps], **ref_kw)
    port = teng.run_batched(port_entry.program, {"source": SOURCES},
                            **CAPS[caps], **port_kw)
    _same(ref, port)


# ---------------------------------------------------------------------------
# with_plan, the plan cache, edge_slot_hwm
# ---------------------------------------------------------------------------

def test_with_plan_rebinds(engines):
    eng, teng = engines["k3"]
    other_eng, other = engines["k4-slack8"]
    moved = teng.with_plan(other.plan)
    assert moved.plan is other.plan and moved.use_kernels == teng.use_kernels
    assert teng.plan is not other.plan
    assert eng.with_plan(other_eng.plan).plan is other_eng.plan
    _same(other_eng.run_batched(E.SSSP, {"source": SOURCES}),
          moved.run_batched(TE.SSSP, {"source": SOURCES}))


def test_plan_cache_matches_reference():
    """The same calls give the same hits, misses, evictions and sizes in
    both packages: a hit for a content-equal graph rebuilt in another slot
    order, an eviction at the 33rd plan; and the port's key holds the
    device."""
    g = RG.barabasi_albert(40, 2, seed=5)
    u, v = g.as_numpy()
    flipped = RG.from_edge_array(g.n_vertices, np.stack([u, v], 1)[::-1])
    assert flipped.fingerprint() == g.fingerprint()
    owner = baselines.hash_partition(g, 2)
    flipped_owner = baselines.hash_partition(flipped, 2)
    tg = TG.graph_from_numpy(g, device=CPU)
    tflipped = TG.graph_from_numpy(flipped, device=CPU)
    E.plan_cache_clear(reset_counters=True)
    TE.plan_cache_clear(reset_counters=True)
    try:
        a = E.compile_plan_cached(g, owner, 2)
        ta = TE.compile_plan_cached(tg, owner, 2, device=CPU)
        assert E.compile_plan_cached(flipped, flipped_owner, 2) is a
        assert TE.compile_plan_cached(tflipped, flipped_owner, 2,
                                      device=CPU) is ta
        assert TE.plan_cache_stats() == E.plan_cache_stats()
        assert TE.plan_cache_stats()["hits"] == 1
        # another device is another key: never the CPU plan
        meta = TE.compile_plan_cached(tg, owner, 2, device="meta")
        assert meta is not ta and meta.device.type == "meta"
        assert TE.plan_cache_stats()["misses"] == 2
        E.compile_plan_cached(g, owner, 2, epoch=99)
        for epoch in range(1, 32):
            E.compile_plan_cached(g, owner, 2, epoch=epoch)
            TE.compile_plan_cached(tg, owner, 2, epoch=epoch, device=CPU)
        assert TE.plan_cache_stats() == E.plan_cache_stats()
        assert E.plan_cache_stats()["evictions"] == 1
        assert E.plan_cache_stats()["size"] == 32
    finally:
        E.plan_cache_clear(reset_counters=True)
        TE.plan_cache_clear(reset_counters=True)


def _patched(plan, g, owner):
    """Delete a few live edges and insert new ones, some with graph slots
    past the edge plane (``edge_slot`` beyond ``e_pad``)."""
    rng = np.random.default_rng(0)
    u, v = g.as_numpy()
    own = np.asarray(owner)[np.asarray(g.edge_mask)]
    changes = [EdgeChange(int(u[i]), int(v[i]), int(own[i]), -1)
               for i in rng.choice(len(u), size=4, replace=False)]
    present = set(zip(u.tolist(), v.tolist()))
    while len(changes) < 10:
        a, b = sorted(rng.integers(0, 150, 2).tolist())
        if a != b and (a, b) not in present:
            present.add((a, b))
            changes.append(EdgeChange(a, b, -1, int(rng.integers(plan.k)),
                                      g.e_pad + len(changes)))
    return patch_plan(plan, changes)


def test_edge_slot_hwm_matches_reference(engines):
    g = _graph()
    owner = baselines.hash_partition(g, 4)
    plans = [eng.plan for eng, _ in engines.values()]
    plans.append(_patched(engines["k4-slack8"][0].plan, g, owner))
    for plan in plans:
        port = TE.plan_from_numpy(plan, device=CPU)
        assert port.edge_slot_hwm == plan.edge_slot_hwm
    assert plans[-1].edge_slot_hwm > g.e_pad


def test_pending_result_handle(engines):
    _, teng = engines["k3"]
    pending = teng.dispatch_batched(TE.SSSP, {"source": SOURCES})
    assert pending.block_until_ready() is pending
    one = teng.dispatch(TE.SSSP, source=7)
    res = pending.result()
    assert torch.equal(res.state[1], one.result().state)
    assert res.total_exchanged == \
        int(res.supersteps.max()) * teng.plan.exchange_volume
