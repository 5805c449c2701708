"""The port's program registry against the JAX package's: for the same
seeded inputs both give the same normalized params, batch and cache keys
(channel planes compared by their content digests), the same
``ChannelValue`` digests, the same error type and message for every
registration and request misuse, and the same ``validate_channels``
errors for vertex/edge plane mix-ups. The nine built-in programs are
registered in both with the same schema."""
import numpy as np
import pytest

from repro import engine as E
from repro import gserve as G
from repro.core import baselines
from repro.core import graph as RG
from repro.engine import registry as RR
from repro_torch import engine as TE
from repro_torch import gserve as TG
from repro_torch.engine import registry as TR

N = 60


def _graph():
    return RG.barabasi_albert(N, 3, seed=5)


def _planes(seed: int) -> dict:
    """Seeded channel planes and parameters for every built-in program."""
    rng = np.random.default_rng(seed)
    g = _graph()
    return {
        "sssp": {"source": int(rng.integers(N))},
        "bfs": {"source": np.int64(rng.integers(N))},
        "wsssp": {"source": int(rng.integers(N))},
        "wcc": {},
        "pagerank": {} if seed % 2 else {"iters": int(rng.integers(1, 40))},
        "labelprop": {"labels": rng.integers(0, 30, N).astype(np.float32)},
        "ppr": {"personalization": rng.random(N), "iters": 12},
        "gcn_layer": {"x": rng.normal(size=(N, TE.GCN_F_IN)),
                      "weight": rng.normal(size=(TE.GCN_F_IN, TE.GCN_F_OUT))},
        "kge_score": {"entity": rng.normal(size=(N, TE.KGE_F)),
                      "relation": rng.normal(size=(g.e_pad, TE.KGE_F))},
    }


def _plain(x):
    """A key or params value with channel planes replaced by their digests,
    so the two packages' values compare."""
    if isinstance(x, (E.ChannelValue, TE.ChannelValue)):
        return ("channel", x.digest, x.shape)
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _schema(spec) -> tuple:
    """A ParamSpec's fields (the required-sentinel is each package's own)."""
    return (spec.name, spec.dtype, spec.batchable, spec.role, spec.channel,
            spec.features, spec.required,
            None if spec.required else spec.default,
            spec.validate is None)


def test_same_programs_and_schemas():
    assert TE.program_names() == E.program_names()
    for name in E.program_names():
        ref, port = E.get_program(name), TE.get_program(name)
        assert [_schema(p) for p in port.params] == \
            [_schema(p) for p in ref.params], name
        assert [n for n, _ in port.resources] == [n for n, _ in ref.resources]
        assert (port.cacheable, port.oracle_atol, port.batchable) == (
            ref.cacheable, ref.oracle_atol, ref.batchable)
        assert port.state.key() == ref.state.key()
        assert port.program.name == ref.program.name == name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_planes(0)))
def test_derived_keys_match_reference(name, seed):
    params = _planes(seed)[name]
    ref, port = E.get_program(name), TE.get_program(name)
    a, b = ref.normalize(params), port.normalize(params)
    assert _plain(b) == _plain(a)
    assert _plain(port.batch_key_of(b)) == _plain(ref.batch_key_of(a))
    assert _plain(port.cache_key_of(b)) == _plain(ref.cache_key_of(a))
    assert _plain(port.lane_cache_key(b, 9)) == _plain(
        ref.lane_cache_key(a, 9))
    ra = G.QueryRequest(name, tenant="a", params=params)
    pa = TG.QueryRequest(name, tenant="a", params=params)
    assert _plain(pa.batch_key()) == _plain(ra.batch_key())
    assert _plain(pa.cache_key()) == _plain(ra.cache_key())


@pytest.mark.parametrize("shape", [(7,), (5, 1), (6, 3), (1, 8)])
def test_channel_value_digests_match_reference(shape):
    values = np.random.default_rng(len(shape) + shape[0]).normal(size=shape)
    ref, port = E.ChannelValue(values), TE.ChannelValue(values)
    assert port.digest == ref.digest and port.shape == ref.shape
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
    assert port == TE.ChannelValue(values.copy())
    assert port != TE.ChannelValue(values + 1.0)


def _pos(v):
    if v <= 0:
        raise ValueError("must be > 0")


#: Registration misuse: (id, fn(engine module, registry module)). Each
#: raises in both packages with the same error type and message.
REGISTER_MISUSE = {
    "duplicate": lambda M, R: M.register(
        "sssp", M.SSSP, params=[M.ParamSpec("source", int,
                                             batchable=True)]),
    "two-batch-axes": lambda M, R: R.ProgramRegistry().register(
        "two-axes", M.SSSP, params=[M.ParamSpec("a", int, batchable=True),
                                    M.ParamSpec("b", int, batchable=True)]),
    "duplicate-param": lambda M, R: R.ProgramRegistry().register(
        "dup", M.SSSP, params=[M.ParamSpec("a"), M.ParamSpec("a")]),
    "bad-role": lambda M, R: R.ProgramRegistry().register(
        "badrole", M.SSSP, params=[M.ParamSpec("a", int, role="wat")]),
    "bad-dtype": lambda M, R: R.ProgramRegistry().register(
        "baddtype", M.SSSP, params=[M.ParamSpec("a", str)]),
    "not-a-paramspec": lambda M, R: R.ProgramRegistry().register(
        "notspec", M.SSSP, params=["source"]),
    "bad-default": lambda M, R: R.ProgramRegistry().register(
        "baddefault", M.SSSP, params=[M.ParamSpec("iters", int,
                                                  default=None)]),
    "default-fails-validate": lambda M, R: R.ProgramRegistry().register(
        "badvalidated", M.SSSP, params=[M.ParamSpec("n", int, default=0,
                                                    validate=_pos)]),
    "channel-without-kind": lambda M, R: R.ProgramRegistry().register(
        "c1", M.LABELPROP, params=[M.ParamSpec("x", float, role="channel")]),
    "channel-int": lambda M, R: R.ProgramRegistry().register(
        "c2", M.LABELPROP, params=[M.ParamSpec("x", int, role="channel",
                                               channel="vertex")]),
    "channel-batchable": lambda M, R: R.ProgramRegistry().register(
        "c3", M.LABELPROP, params=[M.ParamSpec(
            "x", float, role="channel", channel="vertex", batchable=True)]),
    "channel-without-role": lambda M, R: R.ProgramRegistry().register(
        "c4", M.LABELPROP, params=[M.ParamSpec("x", float,
                                               channel="vertex")]),
    "channel-no-features": lambda M, R: R.ProgramRegistry().register(
        "c5", M.LABELPROP, params=[M.ParamSpec(
            "x", float, role="channel", channel="vertex", features=0)]),
    "batchable-supersteps": lambda M, R: R.ProgramRegistry().register(
        "c6", M.SSSP, params=[M.ParamSpec("n", int, role="supersteps",
                                          batchable=True)]),
    "unknown-program": lambda M, R: R.ProgramRegistry().get("nope"),
    "unknown-spec": lambda M, R: M.get_program("sssp").spec("radius"),
}

#: Request misuse: (id, params-or-kind) through each package's QueryRequest.
REQUEST_MISUSE = {
    "unknown-param": ("sssp", {"source": 0, "radius": 3}),
    "missing-param": ("sssp", {}),
    "float-for-int": ("sssp", {"source": 1.5}),
    "str-for-int": ("sssp", {"source": "zero"}),
    "bool-for-int": ("sssp", {"source": True}),
    "batch-axis-not-batchable": ("pagerank", {"iters": [10, 20]}),
    "batch-axis-one-request": ("sssp", {"source": np.arange(4)}),
    "validate-hook": ("pagerank", {"iters": -1}),
    "scalar-for-plane": ("labelprop", {"labels": 3.0}),
    "plane-rank": ("labelprop", {"labels": np.zeros((2, 3, 1))}),
    "plane-dtype": ("labelprop", {"labels": np.array(["a", "b"])}),
    "plane-width": ("labelprop", {"labels": np.zeros((N, 2))}),
    "empty-plane": ("labelprop", {"labels": np.zeros((0, 1))}),
    "gcn-weight-rows": ("gcn_layer", {"x": np.zeros((N, TE.GCN_F_IN)),
                                      "weight": np.zeros((3, TE.GCN_F_OUT))}),
    "unknown-kind": ("betweenness", {}),
}


def _error(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 — the test compares whatever
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", REGISTER_MISUSE)
def test_register_misuse_matches_reference(case):
    fn = REGISTER_MISUSE[case]
    ref = _error(lambda: fn(E, RR))
    assert ref is not None, case
    assert _error(lambda: fn(TE, TR)) == ref


@pytest.mark.parametrize("case", REQUEST_MISUSE)
def test_request_misuse_matches_reference(case):
    kind, params = REQUEST_MISUSE[case]
    ref = _error(lambda: G.QueryRequest(kind, params=params))
    assert ref is not None, case
    assert _error(lambda: TG.QueryRequest(kind, params=params)) == ref


@pytest.mark.parametrize("k", [3, 4])
def test_validate_channels_mixups_match_reference(k):
    """A vertex plane where an edge plane belongs and the reverse, too
    short and too long edge planes: the same typed errors and messages
    against the same plan (the port's through ``plan_from_numpy``); a
    valid request lays out the same planes."""
    g = _graph()
    plan = E.compile_plan(g, baselines.hash_partition(g, k), k,
                          edge_slack=8 * (k - 3))
    tplan = TE.plan_from_numpy(plan, device="cpu")
    hwm = plan.edge_slot_hwm
    cases = {
        "labelprop": [{"labels": np.zeros(g.e_pad)},
                      {"labels": np.zeros(N + 1)}],
        "kge_score": [{"entity": np.zeros((N, TE.KGE_F)),
                       "relation": np.zeros((N, TE.KGE_F))},
                      {"entity": np.zeros((N, TE.KGE_F)),
                       "relation": np.zeros((hwm - 1, TE.KGE_F))},
                      {"entity": np.zeros((N, TE.KGE_F)),
                       "relation": np.zeros((g.e_pad + 1, TE.KGE_F))},
                      {"entity": np.zeros((g.e_pad, TE.KGE_F)),
                       "relation": np.zeros((g.e_pad, TE.KGE_F))}],
    }
    for name, bad in cases.items():
        ref, port = E.get_program(name), TE.get_program(name)
        for params in bad:
            want = _error(lambda: ref.validate_channels(
                ref.normalize(params), plan))
            assert want is not None and want[0] == "ChannelError", params
            assert _error(lambda: port.validate_channels(
                port.normalize(params), tplan)) == want
            assert _error(lambda: port.channel_args(
                port.normalize(params), tplan)) == want
    rng = np.random.default_rng(k)
    params = {"entity": rng.normal(size=(N, TE.KGE_F)),
              "relation": rng.normal(size=(hwm, TE.KGE_F))}
    ref, port = E.get_program("kge_score"), TE.get_program("kge_score")
    want = ref.channel_args(ref.normalize(params), plan)
    got = port.channel_args(port.normalize(params), tplan)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].device == tplan.device
    stats = TE.resident_stats()
    assert stats["planes"] >= 2 and stats["misses"] >= 2


def test_bind_channel_matches_reference():
    """A bound plane stands in for an omitted channel param with the same
    digest in both packages; unbinding makes the param required again."""
    lab = np.random.default_rng(7).integers(0, 30, N).astype(np.float32)
    try:
        ref = E.bind_channel("labelprop", "labels", lab)
        port = TE.bind_channel("labelprop", "labels", lab)
        assert port.digest == ref.digest
        a = G.QueryRequest("labelprop")
        b = TG.QueryRequest("labelprop")
        assert _plain(b.cache_key()) == _plain(a.cache_key())
        assert _error(lambda: TE.bind_channel("pagerank", "iters", lab)) == \
            _error(lambda: E.bind_channel("pagerank", "iters", lab))
    finally:
        E.unbind_channel("labelprop", "labels")
        TE.unbind_channel("labelprop", "labels")
    assert _error(lambda: TG.QueryRequest("labelprop")) == \
        _error(lambda: G.QueryRequest("labelprop"))
