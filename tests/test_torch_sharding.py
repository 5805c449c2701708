"""The port's sharding environment and spec trees against the reference's.

For every architecture, with no mesh, on a 2×4 (data, model) mesh and on a
2×2×2 (pod, data, model) mesh, the port's parameter, cache and cross-k/v
stand-ins must equal the reference's leaf for leaf: keys, padded shapes,
dtypes and logical specs. The reference's side runs in-process under
``jax.sharding.AbstractMesh``, which holds axis names and sizes only.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as ref_config
from repro.launch import specs as RS
from repro.models import lm as RL
from repro.sharding import env as RE
from repro_torch.configs import all_archs, get_config
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS
from repro_torch.models import lm as PL
from repro_torch.sharding import env as PE

MESHES = {"none": None, "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: Decode batches: one that splits over dp on both meshes, one below dp.
BATCHES = (8, 1)
S_MAX = 64


def _ref_mesh(m):
    return None if m is None else AbstractMesh(*m)


def _port_mesh(m):
    return None if m is None else PE.Mesh(*m)


def _flat_ref(structs, specs, path=""):
    out = {}
    if isinstance(structs, dict):
        for k in structs:
            out.update(_flat_ref(structs[k], specs[k], f"{path}/{k}"))
    elif isinstance(structs, (tuple, list)):
        for i, (a, b) in enumerate(zip(structs, specs, strict=True)):
            out.update(_flat_ref(a, b, f"{path}/{i}"))
    else:
        out[path] = (tuple(structs.shape), np.dtype(structs.dtype).name,
                     tuple(specs))
    return out


def _flat_port(structs, specs, path=""):
    out = {}
    if isinstance(structs, torch.Tensor):
        assert structs.device.type == "meta"
        out[path] = (tuple(structs.shape),
                     str(structs.dtype).removeprefix("torch."), tuple(specs))
    elif isinstance(structs, dict):
        for k in structs:
            out.update(_flat_port(structs[k], specs[k], f"{path}/{k}"))
    else:
        for i, (a, b) in enumerate(zip(structs, specs, strict=True)):
            out.update(_flat_port(a, b, f"{path}/{i}"))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_spec_trees_equal_reference(arch, mesh):
    """Parameters, caches (a batch that splits over dp and one below it)
    and, for encdec, the cross k/v: the same leaves, padded shapes, dtypes
    and logical specs as the reference's."""
    m = MESHES[mesh]
    rcfg, cfg = ref_config(arch), get_config(arch)
    with RE.use_mesh(_ref_mesh(m)):
        ref = {"params": _flat_ref(*RS.param_structs(rcfg))}
        for b in BATCHES:
            ref[f"caches{b}"] = _flat_ref(*RL.cache_struct(rcfg, b, S_MAX))
        if rcfg.family == "encdec":
            ref["cross"] = _flat_ref(*RL.cross_kv_struct(rcfg, BATCHES[0]))
    with PE.use_mesh(_port_mesh(m)):
        port = {"params": _flat_port(*PS.param_structs(cfg))}
        for b in BATCHES:
            port[f"caches{b}"] = _flat_port(*PS.cache_structs(cfg, b, S_MAX))
        if cfg.family == "encdec":
            port["cross"] = _flat_port(*PS.cross_structs(cfg, BATCHES[0]))
    for name in ref:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("arch", all_archs())
def test_no_mesh_keeps_the_one_device_shapes(arch):
    """With no env active, ``param_shapes`` and ``cache_struct`` are the
    one-device shapes: padded at tp = 1 (a mesh of one chip gives the
    same)."""
    cfg = get_config(arch)
    plain = (PL.param_shapes(cfg), PL.cache_struct(cfg, 4, 32))
    with PE.use_mesh(PM.make_mesh((1, 1), ("data", "model"))):
        assert (PL.param_shapes(cfg), PL.cache_struct(cfg, 4, 32)) == plain
    assert PE.get_env() == PE.MeshEnv()


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2", "16x16", "2x16x16"])
def test_env_sizes_and_resolution_equal_reference(mesh):
    """``env_from_mesh``'s axes and sizes, and ``logical_spec``'s
    resolution of every logical spec the model code uses, against the
    reference's ``PartitionSpec``s."""
    m = MESHES.get(mesh) or (((16, 16), ("data", "model")) if mesh == "16x16"
                             else ((2, 16, 16), ("pod", "data", "model")))
    specs = [("dp", None), ("tp", "fsdp"), ("fsdp", "tp", None),
             (None, ("dp", "tp"), None), ("dp", None, "tp"), (), (None,),
             ("model",)]
    with RE.use_mesh(_ref_mesh(m)) as renv:
        want = [RE.logical_spec(*s) for s in specs]
    penv = PE.env_from_mesh(_port_mesh(m))
    assert (penv.dp, penv.fsdp, penv.tp) == (renv.dp, renv.fsdp, renv.tp)
    assert (penv.dp_size(), penv.tp_size()) == (renv.dp_size(),
                                                renv.tp_size())
    for s, w in zip(specs, want):
        got = PE.logical_spec(*s, env=penv)
        w = tuple(w) + (None,) * (len(s) - len(w))
        norm = tuple(() if e is None else e if isinstance(e, tuple)
                     else (e,) for e in w)
        assert got == norm, s
    assert isinstance(want[0], PartitionSpec)


def test_shard_shape_is_xla_ceil_rule():
    env = PE.env_from_mesh(PE.Mesh((2, 4), ("data", "model")))
    assert PE.shard_shape((151936, 1024), ("tp", "fsdp"), env) == (37984, 512)
    assert PE.shard_shape((7, 3, 5), ("tp", ("dp", "tp"), None), env) == (
        2, 1, 5)
    assert PE.shard_shape((1, 9), ("dp", None), env) == (1, 9)
    assert PE.shard_shape((10, 10), (None, None)) == (10, 10)
    with pytest.raises(ValueError):
        PE.shard_shape((3,), (None, None), env)


def test_use_mesh_is_a_thread_local_context_and_shard_is_identity():
    mesh = PM.make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and PM.make_production_mesh().size == 256
    x = torch.ones(3)
    with PE.use_mesh(mesh) as env:
        assert env.dp == ("pod", "data") and env.tp_size() == 16
        assert PE.get_env() is env
        assert PE.shard(x, "dp", None) is x
        inner = PE.MeshEnv()
        PE.set_env(inner)
        assert PE.get_env() is inner
    assert not PE.get_env().active


def test_make_device_mesh_needs_a_live_group_of_its_size():
    with pytest.raises(RuntimeError, match="live process group of 8"):
        PE.Mesh((2, 4), ("data", "model")).make_device_mesh("cpu")
    with pytest.raises(ValueError):
        PE.Mesh((2, 4), ("data",))


def test_mesh_peaks_are_the_cards():
    """The port states the H100's published peaks, never another chip's."""
    assert PM.CARD == "NVIDIA H100 SXM5 80GB" and PM.POWER_LIMIT_W == 700
    assert PM.PEAK_FLOPS_BF16 == 1979e12 / 2
    assert (PM.FP32_FLOPS, PM.HBM_BW, PM.LINK_BW) == (67e12, 3.35e12, 450e9)
    from repro_torch.obs import profile
    assert (profile.PEAK_FLOPS, profile.PEAK_HBM_BPS) == (PM.FP32_FLOPS,
                                                          PM.HBM_BW)
