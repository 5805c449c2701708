"""The sharding environment's host-side rules, in this process with no
process group: how a rank's shard is cut (``shard_tensor``, its padding
and the SSM's split halves), which kv heads a tp rank's q heads read,
``parse_mesh``, and a rank's dp index. The sharded runs themselves are
``tests/test_torch_sharded_lm.py``."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import layers as TLy
from repro_torch.sharding.env import (Live, Mesh, MeshEnv, Placement,
                                      env_from_mesh, shard, shard_shape,
                                      shard_tensor)


def _env(dims, names, coords) -> MeshEnv:
    """A live env of ``dims`` as the rank at ``coords`` sees it (its groups
    are never used by the host-side rules)."""
    return env_from_mesh(Mesh(dims, names), Live(
        groups=dict.fromkeys(names), coords=dict(zip(names, coords))))


def _all_shards(t, spec, dims, names, halves=False):
    return {c: shard_tensor(t, spec, _env(dims, names, c), halves)
            for c in itertools.product(*map(range, dims))}


@pytest.mark.parametrize("shape,spec", [
    ((7, 5), ("fsdp", "tp")), ((3, 8, 6), (None, "tp", "fsdp")),
    ((5,), ("tp",)), ((4, 6), (None, None))])
def test_shards_tile_the_padded_tensor(shape, spec):
    """Every rank's shard has ``shard_shape``; laid out by the ranks'
    coordinates they are the tensor zero-padded to n · ceil(dim / n)."""
    dims, names = (2, 3), ("data", "model")
    t = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape) + 1
    shards = _all_shards(t, spec, dims, names)
    env = _env(dims, names, (0, 0))
    local = shard_shape(shape, spec, env)
    axis = {"fsdp": 0, "tp": 1}
    padded = torch.zeros([d * (dims[axis[s]] if s else 1) if s else d
                          for d, s in zip(local, spec)])
    for c, part in shards.items():
        assert tuple(part.shape) == local
        idx = tuple(slice(c[axis[s]] * n, (c[axis[s]] + 1) * n) if s
                    else slice(None) for n, s in zip(local, spec))
        padded[idx] = part
    full = padded[tuple(slice(0, d) for d in shape)]
    assert torch.equal(full, t)
    assert float(padded.sum()) == float(t.sum())   # the pad is zeros


def test_halves_give_a_rank_its_channels_of_both():
    """The SSM's ``in_proj`` [d, 2 · d_inner]: rank i of tp holds channels
    [i · c, (i + 1) · c) of x and of the gate, side by side."""
    d, d_in, tp = 3, 8, 2
    t = torch.arange(d * 2 * d_in, dtype=torch.float32).reshape(d, 2 * d_in)
    for i in range(tp):
        got = shard_tensor(t, ("fsdp", "tp"),
                           _env((1, tp), ("data", "model"), (0, i)),
                           halves=True)
        c = d_in // tp
        want = torch.cat([t[:, i * c:(i + 1) * c],
                          t[:, d_in + i * c:d_in + (i + 1) * c]], dim=1)
        assert torch.equal(got, want)


def test_placement_checks_the_full_shape():
    env = _env((2, 2), ("data", "model"), (1, 0))
    pl = Placement(("fsdp", "tp"), (4, 6))
    assert shard_shape(pl.shape, pl.spec, env) == (2, 3)
    assert tuple(pl.shard(torch.ones(4, 6), env).shape) == (2, 3)
    with pytest.raises(ValueError, match="placement for"):
        pl.shard(torch.ones(4, 5), env)


def test_a_shard_never_views_the_full_tensor():
    t = torch.ones(4, 4)
    part = shard_tensor(t, ("fsdp", None), _env((2, 1), ("data", "model"),
                                                (1, 0)))
    t.zero_()
    assert float(part.sum()) == 8.0


@pytest.mark.parametrize("h_loc,kv,tp,want", [
    (2, 2, 2, {0: [0], 1: [1]}),          # qwen3 SMOKE: 4 q heads, 2 kv
    (4, 8, 4, {0: [0, 1], 3: [6, 7]}),    # 16 q heads over 8 kv, tp 4
    (1, 8, 16, {0: [0], 1: [0], 15: [7]}),   # a kv head shared by 2 ranks
    (3, 4, 4, {0: [0], 3: [3]}),          # 3 q heads a kv head, a rank
    (3, 3, 2, {0: [0, 0, 1], 1: [1, 2, 2]}),  # not aligned: one a q head
    (2, 2, 3, {0: [0], 1: [0, 1], 2: [1]}),   # aligned, one each
    (4, 4, 1, {0: [0, 1, 2, 3]})])        # one rank: every kv head
def test_local_kv_heads(h_loc, kv, tp, want):
    for index, heads in want.items():
        assert TLy.local_kv_heads(h_loc, kv, tp, index) == heads


def test_parse_mesh_takes_the_reference_launchers_forms():
    assert parse_mesh("1x1") == Mesh((1, 1), ("data", "model"))
    assert parse_mesh("2x4") == Mesh((2, 4), ("data", "model"))
    assert parse_mesh("2x16x16") == Mesh((2, 16, 16),
                                         ("pod", "data", "model"))
    assert parse_mesh("8") == Mesh((8,), ("data",))
    for bad in ("2x2x2x2", "0x2", "x"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


def test_dp_index_is_pod_major_and_shard_is_the_identity():
    names = ("pod", "data", "model")
    env = _env((2, 3, 2), names, (1, 2, 1))
    assert (env.dp_index(), env.tp_index(), env.dp_size()) == (5, 1, 6)
    x = torch.ones(3)
    assert shard(x, "dp") is x
    assert not MeshEnv().is_live and MeshEnv().dp_index() == 0
    assert not env_from_mesh(Mesh((2, 2), ("data", "model"))).is_live
