"""repro_torch's Engine over a ``torch.distributed`` process group against
repro's ``Engine(plan, mesh=...)``.

For each world size n (2 and 4; K = 8, so two partitions a rank at 4) the
reference runs in a subprocess with ``XLA_FLAGS`` asking for n host
devices, and the port runs n gloo ranks on the CPU in a subprocess
(``torch.multiprocessing.spawn``, rendezvous through a file under
``tmp_path``). All four start together in one module fixture and write
their outputs to ``.npz`` files; the tests compare those, with each other
and with the port's single-device Engine in this process. Both packages
run the same plan (the reference's DFEP owner, through the port's DFEP with
the reference's start vertices) and the same seeded inputs.

Min and max programs, lanes and the channel program are held bit for bit
with equal counters; add programs (PageRank, PPR) to the reference's
oracle bound, rtol 1e-5, and gcn_layer / kge_score to 1e-5 of their
largest value. A rank's block of the plan (``shard_plan``) and its kernel
layouts are checked here against a plan built from the same rows.
"""
import json
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from repro.core import graph as RG
from repro.core.graph import edge_weights
from repro_torch import engine as TE
from repro_torch.core import dfep as TD
from repro_torch.core import graph as TG
from repro_torch.core import metrics as TM
from repro_torch.engine import kernels as TK
from repro_torch.engine import plan as TP
from test_torch_dfep_distributed import finish, same_on_every_rank, start

K = 8
WORLDS = (2, 4)
#: A partition count each world does not divide (the reference's error).
K_UNEVEN = {2: 3, 4: 6}
SOURCES = (0, 3, 7, 11, 42, 111)
WARM_SOURCES = (5, 9, 13)
CHANNEL_SOURCES = (1, 7)
PR_ITERS, PPR_ITERS = 20, 12
MIN_PROGRAMS = ("sssp", "wcc", "bfs", "wsssp", "labelprop")
#: PageRank and PPR against the reference: its own oracle bound for the
#: sharded engine (tests/test_engine_distributed.py), relative here, since
#: ranks are ~1e-3; the same float32 sums of at most K terms in another
#: order.
ADD_RTOL = 1e-5
#: gcn_layer and kge_score against the reference, relative to the largest
#: value: their outputs change sign, so an elementwise bound is undefined
#: near 0; the same float32 sums in another order.
GNN_REL = 1e-5
#: exchange add on values in [0, 1): sums of at most K terms in another
#: order (chip_smoke.py's EXCHANGE_ADD_ATOL).
EXCHANGE_ADD_ATOL = 1e-5
EXCHANGE_CASES = [(c, f) for c in ("min", "add", "max") for f in (1, 8)]


def _graphs():
    ref = RG.watts_strogatz(300, 6, 0.1, seed=2)
    return ref, TG.graph_from_numpy(ref, device="cpu")


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    n = int(sys.argv[1])
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import graph
    from repro import engine as E

    inp = np.load(sys.argv[2])
    out_path = sys.argv[3]
    g = graph.watts_strogatz(300, 6, 0.1, seed=2)
    plan = E.compile_plan(g, inp["owner"], int(inp["k"]))
    mesh = jax.make_mesh((n,), ("parts",))
    eng = E.Engine(plan, mesh=mesh)
    deg = g.degrees()
    runs = {
        "sssp": lambda: E.engine_sssp(eng, 0),
        "wcc": lambda: E.engine_wcc(eng),
        "bfs": lambda: E.engine_bfs(eng, 0),
        "wsssp": lambda: E.engine_weighted_sssp(eng, 0),
        "labelprop": lambda: E.engine_label_propagation(eng, inp["labels"]),
        "pagerank": lambda: E.engine_pagerank(eng, deg,
                                              iters=int(inp["pr_iters"])),
        "ppr": lambda: E.engine_personalized_pagerank(
            eng, deg, inp["p"], iters=int(inp["ppr_iters"])),
        "gcn_layer": lambda: E.engine_gcn_layer(eng, deg, inp["x"],
                                                inp["weight"]),
        "kge_score": lambda: E.engine_kge_score(eng, inp["entity"],
                                                inp["relation"]),
        "multi": lambda: E.multi_source_sssp(eng, inp["sources"]),
        "warm": lambda: eng.run_batched(
            E.SSSP, {"source": inp["warm_sources"]},
            warm_state=inp["warm_state"]),
    }
    INF = jnp.float32(jnp.inf)
    def prepare(plan, kw):
        return {"source": kw["source"],
                "w": E.gather_edge_channel(plan, kw["weights"])[:, :, 0]}
    def init(plan, ctx):
        hit = plan.vmask & (plan.local2global == ctx["source"])
        return jnp.where(hit, 0.0, INF)
    def fin(glob, present, plan, ctx):
        iota = jnp.arange(plan.n_vertices)
        return jnp.where(present, glob,
                         jnp.where(iota == ctx["source"], 0.0, INF))
    CW = E.EdgeProgram(name="cwsssp", mode="replica", combine="min",
        prepare=prepare, init=init, pre=lambda s, c: s,
        apply=lambda o, a, c: jnp.minimum(o, a), finalize=fin,
        local_fixpoint=True, edge=lambda m, plan, ctx: m + ctx["w"])
    runs["channel"] = lambda: eng.run_batched(
        CW, {"source": inp["channel_sources"]}, weights=inp["weights"])
    out = {}
    for name, run in runs.items():
        r = run()
        out[name] = np.asarray(r.state)
        out[name + "_counts"] = np.stack([
            np.asarray(r.supersteps).reshape(-1),
            np.asarray(r.local_iters).reshape(-1),
            np.asarray(r.converged).reshape(-1).astype(np.int32)])
        out[name + "_exchange"] = np.array(r.exchange_per_superstep)
    k_bad = int(inp["k_uneven"])
    bad = E.compile_plan(g, inp["owner"] % k_bad, k_bad)
    try:   # its dispatch places the plan first, which JAX refuses with
        E.Engine(bad, mesh=mesh)._k_local()    # its own error: ask the check
    except AssertionError as e:
        out["uneven_error"] = np.array(str(e))
    np.savez(out_path, **out)
""")

PORT_SCRIPT = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def channel_program(TE):
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
            init=init, pre=lambda s, c: s,
            apply=lambda o, a, c: torch.minimum(o, a), finalize=fin,
            local_fixpoint=True, edge=lambda m, plan, ctx: m + ctx["w"])


    def worker(rank, world, rdzv, inputs, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdzv,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        from repro_torch import engine as E, obs
        from repro_torch.core import graph
        from repro_torch.engine import kernels as K
        from repro_torch.engine.plan import shard_plan

        inp = np.load(inputs)
        group = dist.group.WORLD
        g = graph.watts_strogatz(300, 6, 0.1, seed=2, device="cpu")
        plan = E.compile_plan(g, inp["owner"], int(inp["k"]), device="cpu")
        eng = E.Engine(plan, group=group)
        deg = g.degrees()
        cw = E.register("cwsssp", channel_program(E), params=[
            E.ParamSpec("source", int, batchable=True),
            E.ParamSpec("weights", float, role="channel", channel="edge")])
        cw_kw = cw.channel_args(cw.normalize(
            {"source": 0, "weights": inp["weights"]}), plan)
        runs = {
            "sssp": lambda: E.engine_sssp(eng, 0),
            "wcc": lambda: E.engine_wcc(eng),
            "bfs": lambda: E.engine_bfs(eng, 0),
            "wsssp": lambda: E.engine_weighted_sssp(eng, 0),
            "labelprop": lambda: E.engine_label_propagation(
                eng, inp["labels"]),
            "pagerank": lambda: E.engine_pagerank(
                eng, deg, iters=int(inp["pr_iters"])),
            "ppr": lambda: E.engine_personalized_pagerank(
                eng, deg, inp["p"], iters=int(inp["ppr_iters"])),
            "gcn_layer": lambda: E.engine_gcn_layer(eng, deg, inp["x"],
                                                    inp["weight"]),
            "kge_score": lambda: E.engine_kge_score(eng, inp["entity"],
                                                    inp["relation"]),
            "multi": lambda: E.multi_source_sssp(eng, inp["sources"]),
            "warm": lambda: eng.run_batched(
                E.SSSP, {"source": inp["warm_sources"]},
                warm_state=inp["warm_state"]),
            "channel": lambda: eng.run_batched(
                cw.program, {"source": inp["channel_sources"]}, **cw_kw),
        }
        out = {}
        for name, run in runs.items():
            r = run()
            out[name] = r.state.numpy()
            out[name + "_counts"] = np.stack([
                np.asarray(r.supersteps).reshape(-1),
                np.asarray(r.local_iters).reshape(-1),
                np.asarray(r.converged).reshape(-1).astype(np.int32)])
            out[name + "_exchange"] = np.array(r.exchange_per_superstep)
        for i, s in enumerate(inp["sources"]):
            out[f"solo_{i}"] = E.engine_sssp(eng, int(s)).state.numpy()
        obs.enable()
        try:
            E.engine_wcc(eng)
            out["dispatch_args"] = np.array(json.dumps(
                [e["args"] for e in obs.get().events()
                 if e["name"] == "engine.dispatch"]))
        finally:
            obs.disable()
            obs.reset()
        # the exchange alone, on this rank's block
        local = shard_plan(plan, rank, world)
        k_loc = local.k
        for key in inp.files:
            if key.startswith("values_"):
                _, combine, f = key.split("_")
                vals = torch.from_numpy(inp[key][rank * k_loc:
                                                 (rank + 1) * k_loc].copy())
                out["exchange_" + combine + "_" + f] = K.exchange_sharded(
                    local, vals, combine, group,
                    update=K.masked_update_ref).numpy()
        k_bad = int(inp["k_uneven"])
        bad = E.compile_plan(g, inp["owner"] % k_bad, k_bad, device="cpu")
        try:
            E.engine_sssp(E.Engine(bad, group=group), 0)
        except ValueError as e:
            out["uneven_error"] = np.array(str(e))
        np.savez(f"{out_dir}/port_{world}_{rank}.npz", **out)
        dist.destroy_process_group()


    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(worker, args=(world, sys.argv[2], sys.argv[3], sys.argv[4]),
                 nprocs=world)
""")


@pytest.fixture(scope="module")
def setup():
    """The graph, the DFEP owner both packages run, the seeded inputs and
    the port's single-device plan."""
    ref_g, tg = _graphs()
    n = ref_g.n_vertices
    starts = np.asarray(jax.random.choice(jax.random.key(0), n, shape=(K,),
                                          replace=False))
    owner, _ = TD.partition(tg, K, starts=starts, max_rounds=400,
                            stall_rounds=16, device="cpu")
    plan = TE.compile_plan(tg, owner, K, device="cpu")
    rng = np.random.default_rng(0)
    p = rng.random(n).astype(np.float32)
    u, v = ref_g.as_numpy()
    w = np.zeros(ref_g.e_pad, np.float32)
    w[np.asarray(ref_g.edge_mask)] = edge_weights(u, v)
    # a one-superstep batch as the warm block, one row cold (+inf)
    warm = TE.Engine(plan).run_batched(
        TE.SSSP, {"source": torch.tensor(WARM_SOURCES, dtype=torch.int32)},
        max_supersteps=1).state.numpy()
    warm[1] = np.inf
    inputs = dict(
        k=K, owner=owner.numpy(), pr_iters=PR_ITERS, ppr_iters=PPR_ITERS,
        labels=rng.integers(0, 40, n).astype(np.float32), p=p / p.sum(),
        x=rng.normal(size=(n, TE.GCN_F_IN)).astype(np.float32),
        weight=rng.normal(size=(TE.GCN_F_IN, TE.GCN_F_OUT)).astype(
            np.float32),
        entity=rng.normal(size=(n, TE.KGE_F)).astype(np.float32),
        relation=rng.normal(size=(ref_g.e_pad, TE.KGE_F)).astype(np.float32),
        sources=np.array(SOURCES, np.int32),
        warm_sources=np.array(WARM_SOURCES, np.int32), warm_state=warm,
        channel_sources=np.array(CHANNEL_SOURCES, np.int32), weights=w)
    for combine, f in EXCHANGE_CASES:
        shape = (K, plan.v_max) + ((f,) if f > 1 else ())
        inputs[f"values_{combine}_{f}"] = rng.random(shape).astype(np.float32)
    return tg, plan, inputs


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Start the reference and the port at each world size together; wait
    for all of them; return {world: (reference, [rank outputs])}."""
    tmp = tmp_path_factory.mktemp("engine_dist")
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT)
    procs = {}
    for n in WORLDS:
        inputs = str(tmp / f"inputs_{n}.npz")
        np.savez(inputs, k_uneven=K_UNEVEN[n], **setup[2])
        procs[f"reference world {n}"] = start(
            [sys.executable, "-c", REF_SCRIPT, str(n), inputs,
             str(tmp / f"ref_{n}.npz")])
        procs[f"port world {n}"] = start(
            [sys.executable, str(script), str(n), str(tmp / f"rdzv_{n}"),
             inputs, str(tmp)])
    finish(procs)
    return {n: (dict(np.load(tmp / f"ref_{n}.npz")),
                [dict(np.load(tmp / f"port_{n}_{r}.npz")) for r in range(n)])
            for n in WORLDS}


def _port(runs, world: int, key: str) -> np.ndarray:
    return same_on_every_rank(runs[world][1], key)


def _single(setup, name: str):
    """The port's single-device run of ``name`` on the same plan."""
    tg, plan, inp = setup
    eng = TE.Engine(plan)
    deg = tg.degrees()
    return {
        "sssp": lambda: TE.engine_sssp(eng, 0),
        "wcc": lambda: TE.engine_wcc(eng),
        "bfs": lambda: TE.engine_bfs(eng, 0),
        "wsssp": lambda: TE.engine_weighted_sssp(eng, 0),
        "labelprop": lambda: TE.engine_label_propagation(eng, inp["labels"]),
    }[name]()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", MIN_PROGRAMS)
def test_min_programs_match_reference(runs, setup, world, name):
    """Bit-identical states, equal supersteps, local iterations and
    convergence; and the same state and supersteps as the port's
    single-device Engine."""
    ref = runs[world][0]
    state = _port(runs, world, name)
    counts = _port(runs, world, name + "_counts")
    np.testing.assert_array_equal(state, ref[name])
    np.testing.assert_array_equal(counts, ref[name + "_counts"])
    solo = _single(setup, name)
    np.testing.assert_array_equal(state, solo.state.numpy())
    assert int(counts[0, 0]) == solo.supersteps
    assert bool(counts[2, 0]) == solo.converged


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("pagerank", "ppr"))
def test_add_programs_match_reference(runs, world, name):
    ref = runs[world][0]
    np.testing.assert_allclose(_port(runs, world, name), ref[name],
                               rtol=ADD_RTOL)
    np.testing.assert_array_equal(_port(runs, world, name + "_counts"),
                                  ref[name + "_counts"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("gcn_layer", "kge_score"))
def test_gnn_programs_match_reference(runs, world, name):
    ref = runs[world][0]
    got, want = _port(runs, world, name), ref[name]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GNN_REL * np.abs(want).max()
    np.testing.assert_array_equal(_port(runs, world, name + "_counts"),
                                  ref[name + "_counts"])


@pytest.mark.parametrize("world", WORLDS)
def test_multi_source_lanes_match_reference_and_solo(runs, world):
    """Each lane bit-identical to the reference's lane and to its solo run
    on the sharded engine, with the reference's per-lane counters."""
    ref = runs[world][0]
    lanes = _port(runs, world, "multi")
    np.testing.assert_array_equal(lanes, ref["multi"])
    np.testing.assert_array_equal(_port(runs, world, "multi_counts"),
                                  ref["multi_counts"])
    for i in range(len(SOURCES)):
        np.testing.assert_array_equal(lanes[i], _port(runs, world,
                                                      f"solo_{i}"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("warm", "channel"))
def test_batches_match_reference(runs, world, name):
    """A warm-started batch (one lane cold) and the batched edge-channel
    program: lanes bit for bit, per-lane counters equal."""
    ref = runs[world][0]
    np.testing.assert_array_equal(_port(runs, world, name), ref[name])
    np.testing.assert_array_equal(_port(runs, world, name + "_counts"),
                                  ref[name + "_counts"])


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_partition_count_raises_reference_message(runs, world):
    ref = runs[world][0]
    msg = str(_port(runs, world, "uneven_error"))
    assert msg == str(ref["uneven_error"])
    assert msg == f"k={K_UNEVEN[world]} must be divisible by mesh axis " \
                  f"size {world}"


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_per_superstep_is_messages(runs, setup, world):
    tg, plan, inp = setup
    messages = TM.evaluate(tg, inp["owner"], K, compute_gain=False).messages
    assert int(_port(runs, world, "sssp_exchange")) == messages \
        == int(runs[world][0]["sssp_exchange"]) == plan.exchange_volume


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("combine,f", EXCHANGE_CASES)
def test_exchange_sharded_matches_whole_plan(runs, setup, world, combine, f):
    """The ranks' exchanges, stacked, against the reference chain on the
    whole plan: min and max exact, add within EXCHANGE_ADD_ATOL."""
    _, plan, inp = setup
    want = TK.exchange_ref(plan, torch.from_numpy(
        inp[f"values_{combine}_{f}"]), combine).numpy()
    got = np.concatenate([out[f"exchange_{combine}_{f}"]
                          for out in runs[world][1]])
    if combine == "add":
        np.testing.assert_allclose(got, want, rtol=0, atol=EXCHANGE_ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_dispatch_event_records_sharded(runs, world):
    (args,) = json.loads(str(_port(runs, world, "dispatch_args")))
    assert args["sharded"] is True and args["program"] == "wcc"
    assert args["exchange_per_superstep"] == \
        int(runs[world][0]["wcc_exchange"])


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 2)])
def test_channels_on_a_block_read_the_whole_plane(setup, world, rank):
    """A channel plane is resident once per content, rows and device, for
    a block and the whole plan alike (the plane is global); the block's
    gathers are the whole plan's rows."""
    _, plan, inp = setup
    block = TP.shard_plan(plan, rank, world)
    k_loc = K // world
    rows = slice(rank * k_loc, (rank + 1) * k_loc)
    entry = TE.get_program("kge_score")
    params = entry.normalize({"entity": inp["entity"],
                              "relation": inp["relation"]})
    whole, local = entry.channel_args(params, plan), \
        entry.channel_args(params, block)
    for name in ("entity", "relation"):
        assert local[name] is whole[name], name
    assert torch.equal(TK.gather_vertex_channel(block, local["entity"]),
                       TK.gather_vertex_channel(plan, whole["entity"])[rows])
    assert torch.equal(TK.gather_edge_channel(block, local["relation"]),
                       TK.gather_edge_channel(plan, whole["relation"])[rows])


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 0), (4, 3)])
def test_shard_plan_block_and_layouts(setup, world, rank):
    """A rank's block holds the plan's rows with ``k = K / world`` and the
    other static fields unchanged, and its kernel layouts equal those of a
    plan built from the same rows; segment_reduce on the block gives the
    whole plan's rows."""
    _, plan, _ = setup
    block = TP.shard_plan(plan, rank, world)
    k_loc = K // world
    rows = slice(rank * k_loc, (rank + 1) * k_loc)
    fields = {f: getattr(plan, f).numpy()[rows] for f in TP.TENSOR_FIELDS}
    fields.update({f: getattr(plan, f) for f in TP.STATIC_FIELDS}, k=k_loc)
    fresh = TP.plan_from_numpy(fields, device="cpu")
    assert block.k == k_loc
    for f in TP.STATIC_FIELDS:
        assert getattr(block, f) == getattr(fresh, f), f
    for f in TP.TENSOR_FIELDS:
        assert torch.equal(getattr(block, f), getattr(fresh, f)), f
        assert getattr(block, f).is_contiguous(), f
    for build in (TK.build_segment_layout, TK.build_exchange_layout):
        a, b = build(block), build(fresh)
        for name in a.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) \
                else x == y, name
    a, b = TK.build_gspmm_layout(block), TK.build_gspmm_layout(fresh)
    for name in ("slot_targets", "chunks", "counters"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    msgs = torch.rand((K, plan.e_max), generator=torch.Generator()
                      .manual_seed(rank))
    assert torch.equal(TK.segment_reduce_ref(block, msgs[rows], "min"),
                       TK.segment_reduce_ref(plan, msgs, "min")[rows])
    with pytest.raises(ValueError, match="must be divisible"):
        TP.shard_plan(plan, 0, 3)
