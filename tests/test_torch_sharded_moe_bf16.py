"""qwen2-moe's bfloat16 prefill at a (data, model) mesh of 1 x 2 against
one device, in both packages: a caveat of bfloat16 tensor parallelism
that the reference shares, not a port fault.

qwen2-moe-a2.7b's SMOKE config, with ``test_torch_sharded_lm``'s weights
(routers drawn at 0.5, so routing is skewed) and 4 prompts of 512 tokens
(the card's ``shard.moe`` batch), prefilled in bfloat16 compute:

(a) The reference's compiled 1 x 2 prefill (``jax.jit(prefill).lower(...)
    .compile().as_text()``, 4 host devices as ``test_torch_sharded_lm``
    sets them up) all-reduces in float32: XLA promotes the bfloat16
    all-reduces of the tensor-parallel regions. Their operands, though, are
    each shard's bfloat16 product (rounded to bfloat16, then widened), and
    the sum is rounded to bfloat16 before the residual add. The MoE
    combine's psum is float32 from end to end, as the port's is. At two
    ranks an all-reduce of two bfloat16 values, summed in float32 and
    rounded once, is their correctly rounded bfloat16 sum, which a
    bfloat16 all-reduce gives too: the port's 1 x 2 prefill with each
    region's parts reduced in float32 and rounded back is bit for bit the
    port's own.
(b) So the gap is one of bfloat16 tensor parallelism itself: the two
    shards' products round before they are summed, where one device rounds
    the whole product once. The reference's 1 x 2 prefill parts from its
    own 1 x 1 prefill by more than bf16_rel(4) of the largest logit, with
    routing flips, as the port's 1 x 2 parts from the port's 1 x 1; at the
    first layer where a token chooses another expert, its k-th and
    (k + 1)-th router logits lie within two bfloat16 ulps of its largest
    router logit in both runs of either package (a near-tie the rounding
    breaks; from there the changed experts cascade through attention and
    the capacity slots).
"""
import json
import math
import os
import signal
import sys
import textwrap
import time

import numpy as np
import pytest

from test_torch_dfep_distributed import start
from test_torch_sharded_lm import _flat, _np_weights

ARCH = "qwen2-moe-a2.7b"
BATCH, SEQ = 4, 512
#: ``chip_smoke.bf16_rel``: two bf16 runs of an n-layer model that round
#: differently, relative to the largest logit.
N_LAYERS = 4
BF16_REL = 2 * math.sqrt(N_LAYERS) * 2.0 ** -8
TIMEOUT = 600

REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, re
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from functools import partial
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.dryrun import _resolve_tree
    from repro.models import layers as L
    from repro.models import lm
    from repro.serve.serve_step import prefill
    from repro.sharding.env import use_mesh

    weights, out = sys.argv[1:3]
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    inp = np.load(weights)
    prompts = jnp.asarray(inp["prompts"])

    def load(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: load(v, f"{prefix}{k}__") for k, v in tree.items()}
        return inp["w__" + prefix[:-2]]

    # each MoE call's routing, read by a host callback: the worker's own
    # router logits and top-k on the same (replicated) input
    routes = []
    moe = L.moe

    def recorded(cfg_, p, x):
        mo = cfg_.moe
        xc = x.reshape(-1, x.shape[-1]).astype(L.COMPUTE_DTYPE)
        e_pad = p["router"].shape[1]
        logits = (xc @ p["router"].astype(L.COMPUTE_DTYPE)).astype(
            jnp.float32)
        logits = jnp.where(jnp.arange(e_pad)[None, :] < mo.n_experts,
                           logits, -jnp.inf)
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), mo.top_k)
        jax.debug.callback(lambda e, lg: routes.append(
            (np.sort(np.asarray(e), -1), np.asarray(lg))), eidx, logits)
        return moe(cfg_, p, x)

    L.moe = recorded
    rec, info = {}, {}
    for dims in ((1, 1), (1, 2)):
        routes.clear()
        tag = f"{dims[0]}x{dims[1]}"
        if dims == (1, 1):
            shapes, _ = lm.init_params(cfg, jax.random.key(0))
            logits, _ = jax.jit(partial(prefill, cfg))(
                jax.tree.map(jnp.asarray, load(shapes)), prompts)
        else:
            mesh = jax.make_mesh(dims, ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2,
                                 devices=jax.devices()[:2])
            with use_mesh(mesh) as env:
                shapes, specs = lm.init_params(cfg, jax.random.key(0))
                params = jax.tree.map(jax.device_put, load(shapes),
                                      _resolve_tree(env, specs))
                fn = jax.jit(partial(prefill, cfg))
                hlo = fn.lower(params, prompts).compile().as_text()
                logits, _ = fn(params, prompts)
            defs = {m.group(1): m.group(2) for m in re.finditer(
                r"^\\s*(%\\S+) = (.*)$", hlo, re.MULTILINE)}
            comps = {m.group(1): m.group(2) for m in re.finditer(
                r"^(%\\S+) [^\\n]*\\{\\n(.*?)\\n\\}", hlo,
                re.MULTILINE | re.DOTALL)}
            reduces = []
            for name, rhs in defs.items():
                m = re.match(r"(\\(.*?\\)|\\S+) all-reduce\\((.*?)\\)", rhs)
                if not m:
                    continue
                types = re.findall(r"(\\w+)\\[", m.group(1))
                for t, op in zip(types, m.group(2).split(", ")):
                    # the operand's own instruction: a fusion whose body
                    # rounds to bfloat16 and widens back is a bf16 value
                    d = defs.get(op, "")
                    call = re.search(r"calls=(%[\\w.\\-]+)", d)
                    body = comps.get(call.group(1), "") if call else ""
                    where = re.search(r'op_name="([^"]*)"', d)
                    reduces.append({"type": t, "op": where.group(1)
                                    if where else "", "bf16_rounded": bool(
                                        re.search(r"= bf16\\[[^\\n]*"
                                                  r"convert\\(", body))})
            info["all_reduces"] = reduces
        jax.effects_barrier()
        rec[f"logits_{tag}"] = np.asarray(logits.astype(jnp.float32))
        info[f"calls_{tag}"] = len(routes)
        for i, (e, lg) in enumerate(routes):
            rec[f"experts_{tag}_{i}"] = e
            rec[f"router_{tag}_{i}"] = lg
    np.savez(out, **rec)
    print("INFO " + json.dumps(info))
""")

PORT_SCRIPT = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def prefill(cfg, params, prompts):
        from repro_torch.models import layers as L, lm
        from repro_torch.serve import serve_step as SS
        with torch.no_grad(), L.record_routing() as routes:
            logits = SS.prefill(cfg, params, prompts)[0]
        return lm.gather_vocab(logits).float(), routes


    def run(weights, mesh_dims):
        from repro_torch.configs import get_config
        from repro_torch.core import collectives as C
        from repro_torch.models import lm
        from repro_torch.sharding.env import Mesh, use_mesh
        cfg = get_config("qwen2-moe-a2.7b", smoke=True)
        inp = np.load(weights)

        def unflat(shapes, prefix=""):
            if isinstance(shapes, dict):
                return {k: unflat(v, f"{prefix}{k}__")
                        for k, v in shapes.items()}
            return inp["w__" + prefix[:-2]]

        prompts = torch.from_numpy(inp["prompts"])
        out = {}
        if mesh_dims is None:
            params = lm.params_from_reference(
                cfg, unflat(lm.param_shapes(cfg)), "cpu")
            runs = {"1x1": lambda: prefill(cfg, params, prompts)}
        else:
            mesh = Mesh(mesh_dims, ("data", "model"))
            env = use_mesh(mesh, mesh.connect("cpu"))
            env.__enter__()
            params = lm.shard_params(cfg, lm.params_from_reference(
                cfg, unflat(lm.param_shapes(cfg)), "cpu"))
            reduce = C.reduce_from_tp

            def widened(x, group):
                # each region's parts summed in float32, rounded once
                return reduce(x.float(), group).to(x.dtype)

            def promoted():
                C.reduce_from_tp = widened
                try:
                    return prefill(cfg, params, prompts)
                finally:
                    C.reduce_from_tp = reduce

            runs = {"1x2": lambda: prefill(cfg, params, prompts),
                    "1x2_f32_reduce": promoted}
        for tag, fn in runs.items():
            logits, routes = fn()
            out[f"logits_{tag}"] = logits.numpy()
            for i, r in enumerate(routes):
                out[f"experts_{tag}_{i}"] = r.expert_idx.sort(-1)[0].numpy()
                out[f"router_{tag}_{i}"] = r.logits.numpy()
        return out


    def worker(rank, world, rdzv, weights, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdzv,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        res = run(weights, (1, 2))
        if rank == 0:
            np.savez(out, **res)
        dist.destroy_process_group()


    if __name__ == "__main__":
        weights, out, rdzv = sys.argv[1:4]
        if rdzv == "-":
            np.savez(out, **run(weights, None))
        else:
            mp.spawn(worker, args=(2, rdzv, weights, out), nprocs=2)
""")


@pytest.fixture(scope="module")
def prefills(tmp_path_factory):
    """The reference's prefills at 1 x 1 and 1 x 2 (with its compiled
    1 x 2 program's all-reduces), the port's at 1 x 1 and at 1 x 2 over two
    gloo ranks (also with float32 region reduces): {package: arrays},
    the reference's all-reduce summary."""
    tmp = tmp_path_factory.mktemp("moe_bf16")
    w = _np_weights(ARCH, seed=101)
    prompts = np.random.default_rng(7).integers(
        0, 512, (BATCH, SEQ)).astype(np.int64)
    weights = str(tmp / "weights.npz")
    np.savez(weights, prompts=prompts,
             **{"w__" + k: v for k, v in _flat(w).items()})
    script = tmp / "port.py"
    script.write_text(PORT_SCRIPT)
    procs = {
        "reference": start([sys.executable, "-c", REF_SCRIPT, weights,
                            str(tmp / "ref.npz")]),
        "port 1x1": start([sys.executable, str(script), weights,
                           str(tmp / "port1.npz"), "-"]),
        "port 1x2": start([sys.executable, str(script), weights,
                           str(tmp / "port2.npz"), str(tmp / "rdzv")]),
    }
    outs = {}
    deadline = time.monotonic() + TIMEOUT
    try:
        for what, proc in procs.items():
            out, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert proc.returncode == 0, f"{what}:\n{err[-4000:]}"
            outs[what] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    info = json.loads(next(ln for ln in outs["reference"].splitlines()
                           if ln.startswith("INFO "))[5:])
    port = dict(np.load(tmp / "port1.npz"))
    port.update(np.load(tmp / "port2.npz"))
    return {"reference": dict(np.load(tmp / "ref.npz")), "port": port}, info


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


def _flips(run: dict, a: str, b: str) -> list[int]:
    return [int((run[f"experts_{a}_{i}"] != run[f"experts_{b}_{i}"])
                .any(-1).sum()) for i in range(N_LAYERS)]


def test_reference_reduces_bfloat16_parts_in_float32(prefills):
    """(a): every all-reduce of the reference's compiled 1 x 2 prefill is
    float32; those of the tensor-parallel products (attention's output
    projection, the shared expert's down projection) reduce each shard's
    bfloat16-rounded product; the MoE combine reduces float32 sums."""
    _, info = prefills
    operands = info["all_reduces"]
    assert {r["type"] for r in operands} == {"f32"}, operands
    dots = [r["bf16_rounded"] for r in operands if "dot_general" in r["op"]]
    assert len(dots) == 2 and all(dots), operands
    combine = [r["bf16_rounded"] for r in operands
               if "shard_map" in r["op"]]
    assert combine == [False], operands


def test_float32_region_reduces_change_nothing_at_two_ranks(prefills):
    """(a) in the port: the regions' parts summed in float32 and rounded
    once give the bfloat16 all-reduce's logits bit for bit."""
    port = prefills[0]["port"]
    np.testing.assert_array_equal(port["logits_1x2_f32_reduce"],
                                  port["logits_1x2"])


@pytest.mark.parametrize("package", ["reference", "port"])
def test_sharded_bf16_prefill_parts_from_one_device_by_near_ties(
        prefills, package):
    """(b): in each package the 1 x 2 prefill parts from the 1 x 1 prefill
    by more than bf16_rel(4) of the largest logit, tokens choose other
    experts, and at the first layer where any does each such token's k-th
    and (k + 1)-th router logits lie within two bfloat16 ulps of its
    largest router logit in both runs."""
    run = prefills[0][package]
    assert _rel(run["logits_1x2"], run["logits_1x1"]) > BF16_REL
    flips = _flips(run, "1x2", "1x1")
    assert sum(flips) > 0
    first = next(i for i, n in enumerate(flips) if n)
    changed = np.nonzero((run[f"experts_1x2_{first}"]
                          != run[f"experts_1x1_{first}"]).any(-1))[0]
    top_k = run[f"experts_1x1_{first}"].shape[-1]
    for t in changed:
        for tag in ("1x1", "1x2"):
            v = np.sort(run[f"router_{tag}_{first}"][t])[::-1]
            top = np.abs(v[np.isfinite(v)]).max()
            gap = v[top_k - 1] - v[top_k]
            assert gap <= 2 * _bf16_ulp(top), (tag, t, gap, top)


def test_each_package_parts_from_one_device_as_the_other_does(prefills):
    """(b): the port's sharded-against-one-device gap and the reference's
    are of one size (each within twice the other), as are two one-device
    bfloat16 runs of the two packages; in float32 the port's sharded MoE
    is held to the reference's in ``test_torch_sharded_lm``."""
    ref, port = prefills[0]["reference"], prefills[0]["port"]
    gaps = {"reference": _rel(ref["logits_1x2"], ref["logits_1x1"]),
            "port": _rel(port["logits_1x2"], port["logits_1x1"]),
            "one device": _rel(port["logits_1x1"], ref["logits_1x1"])}
    for a in gaps.values():
        for b in gaps.values():
            assert a <= 2 * b, gaps
