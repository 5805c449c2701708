"""repro_torch.engine.kernels.ExchangeLayout: the per-plan replica layout
that ``csrc/replica_exchange.cu`` walks. The CUDA kernel runs only on a
card (``tests/test_torch_gpu.py``); here the layout's groups are held to a
numpy recount of ``local2global``, a numpy walk reads the layout as the
kernel's threads do (each group folded in layout order from the identity
and written to its slots, private live slots copied, padding set to the
identity, four slots a thread at F = 1) and must write every element
once, and ``exchange_layout_ref`` (that reading in PyTorch) and
``exchange_ref`` (the reference's scatter-and-gather chain) are held to
the JAX package's ``runtime._exchange`` with the Pallas ``masked_update``
in interpret mode: min and max bit-identical, add within 1e-5 (the same
float32 terms summed in another order). Plans: compiled, patched with
slack, a hub in all 16 partitions, an empty partition, and one whose Vmax
is not a multiple of 4."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import engine as E
from repro.core import graph as RG
from repro.engine import runtime as RR
from repro_torch import engine as TE
from repro_torch.engine import kernels as TK

from test_torch_segment_layout import plans as seg_plans  # noqa: F401

CPU = "cpu"
COMBINES = ("min", "max", "add")
ADD_ATOL = 1e-5
IDENT = {"min": np.inf, "max": -np.inf, "add": 0.0}
OPS = {"min": np.minimum, "max": np.maximum, "add": np.add}
PLANS = ("fresh", "patched", "hub_all", "empty_part", "odd_vmax")


def _hub_all(k: int = 16, leaves: int = 160):
    """A star of ``leaves`` leaves on a ring, each edge owned by partition
    ``dst % k``: the hub sits in all k partitions, each leaf in two or
    three."""
    n = leaves + 1
    star = np.stack([np.zeros(leaves, np.int64), np.arange(1, n)], 1)
    ring = np.stack([np.arange(1, n - 1), np.arange(2, n)], 1)
    g = RG.from_edge_array(n, np.concatenate([star, ring]))
    owner = np.where(np.asarray(g.edge_mask), np.asarray(g.dst) % k, -2)
    return E.compile_plan(g, owner, k)


def _odd_vmax(plan, pad: int = 1):
    """``plan`` with ``pad`` dead vertex slots appended to every partition
    (Vmax % 4 == 1 for a Vmax that is a multiple of 128)."""
    def grow(t, fill):
        t = np.asarray(t)
        return np.concatenate(
            [t, np.full((plan.k, pad), fill, t.dtype)], 1)
    return dataclasses.replace(
        plan, v_max=plan.v_max + pad,
        local2global=grow(plan.local2global, 0),
        vmask=grow(plan.vmask, False), last_slot=grow(
            plan.last_slot, plan.e_max - 1),
        replicated=grow(plan.replicated, False),
        is_master=grow(plan.is_master, False))


@pytest.fixture(scope="module")
def plans(seg_plans):  # noqa: F811
    """name -> reference plan."""
    out = {name: seg_plans[name] for name in ("fresh", "patched",
                                              "empty_part")}
    out["hub_all"] = _hub_all()
    out["odd_vmax"] = _odd_vmax(seg_plans["empty_part"])
    hub = np.asarray(out["hub_all"].local2global)[:, 0]
    assert (hub == 0).all() and np.asarray(out["hub_all"].replicated)[:, 0] \
        .all()                                  # the hub, in every partition
    odd = out["odd_vmax"]
    assert odd.v_max % 4 == 1 and odd.k * odd.v_max % 4 == 3
    assert not np.asarray(out["empty_part"].vmask)[2].any()
    return out


def _values(plan, features: int, combine: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (plan.k, plan.v_max) + ((features,) if features > 1 else ())
    x = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    if combine == "min":
        x[rng.random(shape) < 0.2] = np.inf          # unreached (SSSP)
    if combine == "add":
        x = (x / 100).astype(np.float32)             # rank/degree-sized
    return x


def _recount(plan) -> dict:
    """vertex -> its live replicated flat slots, ascending (numpy)."""
    l2g = np.asarray(plan.local2global).reshape(-1)
    live = (np.asarray(plan.vmask) & np.asarray(plan.replicated)).reshape(-1)
    out = {}
    for s in np.flatnonzero(live):
        out.setdefault(int(l2g[s]), []).append(int(s))
    return out


def _walk(lay, plan, values, combine, quad: bool):
    """The kernel's reading of ``lay`` in numpy: a thread a group folds its
    slots in layout order from the identity and writes the result to each;
    the slot threads (four slots each with ``quad``, F = 1) write the
    identity to padding and copy private live slots, and skip replicated
    live ones. Returns (out [K·Vmax, F], writes per element)."""
    op, ident = OPS[combine], np.float32(IDENT[combine])
    n = plan.k * plan.v_max
    flat = values.reshape(n, -1)
    vmask = plan.vmask.numpy().reshape(-1)
    rep = plan.replicated.numpy().reshape(-1)
    out = np.full(flat.shape, np.nan, np.float32)
    writes = np.zeros(flat.shape, int)
    ptr, slots = lay.ptr.numpy(), lay.slots.numpy()
    for g in range(lay.n_groups):
        acc = np.full(flat.shape[1], ident, np.float32)
        for s in slots[ptr[g]:ptr[g + 1]]:
            acc = op(acc, flat[s]).astype(np.float32)
        for s in slots[ptr[g]:ptr[g + 1]]:
            out[s] = acc
            writes[s] += 1
    step = 4 if quad else 1
    for s0 in range(0, n, step):
        for s in range(s0, min(s0 + step, n)):
            if not vmask[s]:
                out[s] = ident
                writes[s] += 1
            elif not rep[s]:
                out[s] = flat[s]
                writes[s] += 1
    return out, writes


@pytest.mark.parametrize("name", PLANS)
def test_exchange_layout_groups_match_recount(plans, name):
    """Every vertex with live replicated slots is one group holding exactly
    those slots in ascending order (so ascending partition); groups by
    falling size, then vertex; the counts in ``stats()`` agree."""
    plan = TE.plan_from_numpy(plans[name], device=CPU)
    lay = TK.build_exchange_layout(plan)
    want = _recount(plans[name])
    ptr, slots = lay.ptr.numpy(), lay.slots.numpy()
    assert lay.ptr.dtype == lay.slots.dtype == torch.int32
    assert ptr[0] == 0 and ptr[-1] == len(slots) == lay.n_slots
    l2g = np.asarray(plans[name].local2global).reshape(-1)
    got = {}
    for g in range(lay.n_groups):
        grp = slots[ptr[g]:ptr[g + 1]].tolist()
        assert grp == sorted(grp) and len(grp) > 0
        vertex = int(l2g[grp[0]])
        assert vertex not in got
        got[vertex] = grp
    assert got == want
    keys = [(-len(grp), v) for v, grp in got.items()]
    assert keys == sorted(keys)
    stats = lay.stats()
    assert stats["groups"] == len(want)
    assert stats["replicated_slots"] == sum(map(len, want.values()))
    assert stats["largest_group"] == max(map(len, want.values()))
    assert sum(stats["groups_by_size"].values()) == len(want)
    if name == "hub_all":
        assert lay.largest == plan.k == 16
        assert got[0] == [k * plan.v_max for k in range(plan.k)]


@pytest.mark.parametrize("features", [1, 8])
@pytest.mark.parametrize("name", PLANS)
def test_exchange_walk_writes_each_element_once(plans, name, features):
    """The numpy reading of the kernel writes every element of the output
    exactly once (groups and slot threads never overlap, with four slots a
    thread or one) and equals ``exchange_layout_ref`` bit for bit, for
    every combine."""
    plan = TE.plan_from_numpy(plans[name], device=CPU)
    lay = TK.exchange_layout(plan)
    for combine in COMBINES:
        x = _values(plan, features, combine, seed=len(name) + features)
        want = TK.exchange_layout_ref(plan, torch.from_numpy(x), combine)
        for quad in ((True, False) if features == 1 else (False,)):
            out, writes = _walk(lay, plan, x, combine, quad)
            assert (writes == 1).all(), (combine, quad)
            np.testing.assert_array_equal(out.reshape(x.shape),
                                          want.numpy())


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("features", [1, 8])
@pytest.mark.parametrize("name", PLANS)
def test_exchange_matches_reference(plans, name, features, combine):
    """``exchange_layout_ref`` and ``exchange_ref`` against the JAX
    package's ``_exchange`` (its Pallas ``masked_update`` in interpret
    mode): min and max bit-identical, add within 1e-5. The layout walk and
    the chain agree to the bit for min and max."""
    ref_plan = plans[name]
    plan = TE.plan_from_numpy(ref_plan, device=CPU)
    x = _values(plan, features, combine, seed=3 * len(name) + features)
    want = np.asarray(RR._exchange(ref_plan, jnp.asarray(x), combine, None,
                                   use_pallas=True, interpret=True))
    walk = TK.exchange_layout_ref(plan, torch.from_numpy(x), combine)
    chain = TK.exchange_ref(plan, torch.from_numpy(x), combine)
    for got in (walk, chain):
        assert got.dtype == torch.float32 and got.shape == want.shape
        if combine == "add":
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=ADD_ATOL)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_dispatches_plain_on_cpu(plans):
    """A CPU tensor runs ``exchange_ref`` and launches nothing; a CPU plan
    builds no layout until one is asked for."""
    plan = TE.plan_from_numpy(plans["patched"], device=CPU)
    assert "_exchange_layout" not in plan.__dict__
    x = torch.from_numpy(_values(plan, 8, "add", seed=0))
    before = dict(TK.LAUNCHES)
    got = TK.exchange(plan, x, "add")
    assert TK.LAUNCHES == before
    assert torch.equal(got, TK.exchange_ref(plan, x, "add"))
    assert "_exchange_layout" not in plan.__dict__


def test_exchange_refuses_other_devices_and_bad_plans(plans):
    """No silent fallback: a tensor neither on the CPU nor on one CUDA
    device raises; a live replicated slot whose vertex is out of range
    raises when the layout is built."""
    plan = TE.plan_from_numpy(plans["fresh"], device=CPU)
    meta = torch.empty((plan.k, plan.v_max), device="meta")
    with pytest.raises(ValueError):
        TK.exchange(plan, meta, "min")
    rep = plan.vmask & plan.replicated
    bad = torch.where(rep, plan.n_vertices, plan.local2global)
    with pytest.raises(ValueError, match="local2global"):
        TK.build_exchange_layout(dataclasses.replace(plan,
                                                     local2global=bad))
