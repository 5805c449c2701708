"""repro_torch's sharded LM training and serving over ``torch.distributed``
against repro's GSPMD programs at the same (data, model) mesh.

For each family (dense qwen3-0.6b, moe qwen2-moe-a2.7b, ssm
falcon-mamba-7b, hybrid jamba-v0.1-52b and MLA deepseek-v2-236b, SMOKE
configs) the reference runs in a subprocess on 4 host devices
(``XLA_FLAGS``), its mesh axes Auto (``tests/test_torch_dryrun.py``'s
patch: JAX 0.9's default Explicit axes break the reference's ``shard``):
one jitted step (value and gradient of ``lm_loss``, then
``apply_updates``, as its ``train_step`` runs them) with the parameters
and moments placed by their specs, and ``Engine.generate``, at meshes
1 × 2, 2 × 1 and 2 × 2. The port runs gloo ranks on the CPU
(``torch.multiprocessing.spawn``, file rendezvous): world 2 at 1 × 2 and
2 × 1, world 4 at 2 × 2, each through ``lm.shard_params``,
``train_step``, ``value_and_grad`` and ``Engine.generate`` on its shards.
Both load the same weights, drawn from a numpy seed in the padded shapes,
and both take the same global batch (``SyntheticPipeline``, bit for bit
the same in the two packages, whisper's frames and llava's images
included) and prompts (whisper's with numpy frames; llava's text only,
as both launchers serve it: with images the reference decodes at the
text's offset, ROADMAP's caveat). Every subprocess starts
together in one module fixture and writes ``.npz`` files; the tests
compare them.

Held, per family and mesh: loss, aux, ntok, grad_norm and lr, and every
gathered gradient leaf, to ``tests/test_torch_train_families.py``'s
bounds (LOSS_REL, aux 1e-5 relative, GRAD_REL); every rank's gathered
updated leaves within NEW_ABS of the port's one-device ``apply_updates``
on the same weights and the run's gathered gradients (at step 1 AdamW
moves each element by lr·(±1 + wd·p), lr 3e-6, so a skipped update or a
reversed one fails), and within 2·lr of the reference's plus 1e-6 of its
largest |value| (a gradient whose sign one bfloat16 rounding flips moves
its element by 2·lr); greedy tokens equal. Each
rank's parameter and moment bytes equal ``launch.specs.shard_bytes`` at
its mesh. The MoE's capacity follows the dp-local token count, so its
2 × 2 run differs from its 1 × 2 run: the port follows each. The
collectives' bytes of one dense step are pinned at 2 × 1 and 1 × 2 to a
count derived here from the model's shapes. A checkpoint written at
2 × 2 restores at 1 × 2 and on one device, leaf for leaf, and the
reference's ``CheckpointManager`` reads it; ``launch.train --mesh 1x2``
under ``torch.distributed.run`` resumes from its own checkpoint, and a
mesh or a backend that does not fit raises.
"""
import json
import math
import os
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RC
from repro.train import optimizer as RO
from repro_torch import configs as TC
from repro_torch.ckpt import checkpoint as TCk
from repro_torch.models import lm as TL
from repro_torch.sharding.env import Mesh, use_mesh
from repro_torch.train import optimizer as TO
from test_torch_dfep_distributed import start
from test_torch_train_families import GRAD_REL, LOSS_REL

FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen2-moe-a2.7b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "mla": "deepseek-v2-236b", "encdec": "whisper-small",
            "vlm": "llava-next-34b"}
#: Families run with both packages' compute dtype float32 (as
#: ``tests/test_torch_train_f32.py`` switches it): those with an MoE. In
#: bfloat16 the tp all-reduces round partial sums in another order than
#: XLA's, a router logit moves by a bfloat16 ulp of its input, and a
#: top-k pair that close flips, which moves that expert's gradient by a
#: token's whole contribution and aux by 1e-4; in float32 none flips.
F32 = ("moe", "hybrid", "mla")
#: (data, model) meshes; world 2 runs the first two, world 4 the third.
MESHES = ((1, 2), (2, 1), (2, 2))
WORLD_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
#: The meshes each family runs at: all three for dense, moe and ssm; the
#: families that compose the same regions (hybrid, MLA, encdec's encoder
#: and cross-attention, vlm's prepended images) at 2 x 2 only, where dp,
#: fsdp and tp all split (the reference's compiles are the file's longest
#: part).
FAMILY_MESHES = {"dense": MESHES, "moe": MESHES, "ssm": MESHES,
                 "hybrid": ((2, 2),), "mla": ((2, 2),),
                 "encdec": ((2, 2),), "vlm": ((2, 2),)}
BATCH, SEQ = 4, 32
PROMPTS, PROMPT_LEN, N_NEW, S_MAX = 4, 8, 4, 16
#: A batch dp = 2 does not divide: every dp rank serves all of it, and the
#: MoE splits a call's tokens over dp only when they divide (the
#: reference's ``dp_ok``): the prefill's 3 x 12 do, a decode step's 3 do
#: not. One token repeated, so that its experts overflow: split, each dp
#: half's 18 tokens meet a capacity of 8, whole the 36 one of 11.
ODD_PROMPTS = (3, 12)
AUX_REL = 1e-5
#: Sharded AdamW against one device's on the same gradients: elementwise
#: the same arithmetic, the clip scale from a norm summed in another
#: order; a float32 ulp of the largest weight (a_log's log 16) is 2.4e-7.
NEW_ABS = 1e-6
#: Seconds the fixture's subprocesses may take together.
TIMEOUT = 600


def _mesh_name(dims) -> str:
    return "x".join(map(str, dims))


def _np_weights(arch: str, seed: int) -> dict:
    """Weights in the padded shapes of tp = 2 (equal to tp = 1's for these
    configs): normal draws scaled by each leaf's role, the SSM's
    ``a_log`` S4D-real and ``dt_bias`` a softplus-inverse step, so that
    the models are well conditioned. Routers are drawn at 0.5, not the
    init's 0.006, and the MLPs and experts at 0.2, so that routing is
    skewed enough to overflow capacities and a dropped pair moves the
    step visibly."""
    cfg = TC.get_config(arch, smoke=True)
    with use_mesh(Mesh((1, 2), ("data", "model"))):
        shapes = TL.param_shapes(cfg)
    assert shapes == TL.param_shapes(cfg), "tp padding changed a shape"
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "a_log":
            return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)),
                                   shape).astype(np.float32)
        if name == "dt_bias":
            step = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            return np.log(np.expm1(step)).astype(np.float32)
        z = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("norm") or name == "d_skip":
            return 1.0 + 0.05 * z
        scale = {"conv_w": 0.2, "router": 0.5, "w_gate": 0.2, "w_up": 0.2,
                 "w_down": 0.2,
                 "dt_proj": 1.0 / math.sqrt(shape[-2])}.get(name, 0.02)
        return scale * z

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return draw(name, tuple(tree))

    return walk(shapes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}__"))
        return out
    return {prefix[:-2]: tree}


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticPipeline
    from repro.launch.dryrun import _resolve_tree
    from repro.models import lm
    from repro.serve.serve_step import Engine
    from repro.sharding.env import use_mesh
    from repro.train import optimizer as RO
    from repro.train import train_step as RT

    arch, weights, out, meshes, b, s, s_max, n_new, f32, odd = json.loads(
        sys.argv[1])
    if f32:
        from repro.models import layers as RLy, ssm as RS
        RLy.COMPUTE_DTYPE = RS.COMPUTE_DTYPE = jnp.float32
    cfg = get_config(arch, smoke=True)
    inp = np.load(weights)
    auto = jax.sharding.AxisType.Auto

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            o = {}
            for k in sorted(tree):
                o.update(flat(tree[k], f"{prefix}{k}__"))
            return o
        return {prefix[:-2]: np.asarray(tree)}

    def load(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: load(v, f"{prefix}{k}__") for k, v in tree.items()}
        a = inp["w__" + prefix[:-2]]
        assert a.shape == tree.shape, (prefix, a.shape, tree.shape)
        return a

    batch = SyntheticPipeline(cfg, DataConfig(b, s)).batch_at(0)
    ocfg = RO.AdamWConfig()
    for dims in meshes:
        n = dims[0] * dims[1]
        mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                             axis_types=(auto,) * 2,
                             devices=jax.devices()[:n])
        with use_mesh(mesh) as env:
            shapes, specs = lm.init_params(cfg, jax.random.key(0))
            ps = _resolve_tree(env, specs)
            params = jax.tree.map(jax.device_put, load(shapes), ps)
            opt = RO.init_opt_state(params)
            osh = RO.OptState(NamedSharding(mesh, P()), ps, ps)

            def step(p, o, bt):
                (total, m), g = jax.value_and_grad(
                    lambda q: RT.lm_loss(cfg, q, bt), has_aux=True)(p)
                new_p, _, om = RO.apply_updates(ocfg, p, g, o)
                return new_p, dict(m, **om, total=total), g

            new_p, met, grads = jax.jit(
                step, in_shardings=(ps, osh, None),
                out_shardings=(ps, None, ps))(params, opt, batch)
            rec = {"metric__" + k: np.asarray(v) for k, v in met.items()}
            rec.update({"grad__" + k: v for k, v in flat(grads).items()})
            rec.update({"new__" + k: v for k, v in flat(new_p).items()})
            eng = Engine(cfg, params, s_max=s_max)
            kw = {} if "frames" not in inp.files else {
                "enc_frames": jnp.asarray(inp["frames"]).astype(jnp.bfloat16)}
            rec["tokens"] = np.asarray(eng.generate(
                jnp.asarray(inp["prompts"]), n_new=n_new, **kw))
            if odd and list(dims) == [2, 2]:
                rec["tokens_odd"] = np.asarray(eng.generate(
                    jnp.asarray(inp["odd_prompts"]), n_new=n_new))
        np.savez(f"{out}_{dims[0]}x{dims[1]}.npz", **rec)
""")

PORT_SCRIPT = textwrap.dedent("""
    import datetime, json, os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, world, rdzv, job):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdzv,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.core import collectives as C
        from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
        from repro_torch.launch import specs as PS
        from repro_torch.models import lm
        from repro_torch.serve.serve_step import Engine
        from repro_torch.sharding.env import Mesh, use_mesh
        from repro_torch.train import optimizer as TO
        from repro_torch.train import train_step as TT

        def flat(tree, prefix=""):
            if isinstance(tree, dict):
                o = {}
                for k in sorted(tree):
                    o.update(flat(tree[k], f"{prefix}{k}__"))
                return o
            return {prefix[:-2]: tree}

        def unflat(inp, shapes, prefix):
            if isinstance(shapes, dict):
                return {k: unflat(inp, v, f"{prefix}{k}__")
                        for k, v in shapes.items()}
            return inp[prefix[:-2]]

        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for t in TO.tree_leaves(tree))

        out = {}
        try:
            Mesh((2, 2), ("data", "model")).connect("cpu") if world == 2 \\
                else Mesh((1, 2), ("data", "model")).connect("cpu")
        except RuntimeError as e:
            out["mesh_error"] = np.array(str(e))
        ocfg = TO.AdamWConfig()
        from repro_torch.models import layers as TLy, ssm as TS
        for arch, weights, meshes, f32, odd in job["runs"]:
            TLy.COMPUTE_DTYPE = TS.COMPUTE_DTYPE = (
                torch.float32 if f32 else torch.bfloat16)
            cfg = get_config(arch, smoke=True)
            inp = np.load(weights)
            w = {k[3:]: v for k, v in inp.items() if k.startswith("w__")}
            batch = SyntheticPipeline(
                cfg, DataConfig(job["batch"], job["seq"]), "cpu").batch_at(0)
            prompts = torch.from_numpy(inp["prompts"])
            kw = {} if "frames" not in inp.files else {
                "enc_frames": torch.from_numpy(inp["frames"]).to(
                    torch.bfloat16)}
            for dims in meshes:
                tag = f"{arch}_{dims[0]}x{dims[1]}"
                mesh = Mesh(tuple(dims), ("data", "model"))
                with use_mesh(mesh, mesh.connect("cpu")):
                    full = lm.params_from_reference(
                        cfg, unflat(w, lm.param_shapes(cfg), ""), "cpu")
                    params = lm.shard_params(cfg, full)
                    del full
                    structs, specs = PS.param_structs(cfg)
                    out[tag + "__want_bytes"] = np.array(
                        PS.shard_bytes(structs, specs))
                    opt = TO.init_opt_state(params)
                    C.reset_bytes()
                    t0 = time.perf_counter()
                    new_p, new_o, met = TT.train_step(cfg, ocfg, params,
                                                      opt, batch)
                    out[tag + "__step_s"] = np.array(
                        time.perf_counter() - t0)
                    for kind, n in C.BYTES.items():
                        out[f"{tag}__bytes__{kind}"] = np.array(n)
                    out[tag + "__param_bytes"] = np.array(nbytes(new_p))
                    out[tag + "__m_bytes"] = np.array(nbytes(new_o.m))
                    out[tag + "__v_bytes"] = np.array(nbytes(new_o.v))
                    for k, v in met.items():
                        out[f"{tag}__metric__{k}"] = v.numpy()
                    _, _, grads = TT.value_and_grad(cfg, params, batch)
                    for k, v in flat(lm.gather_params(cfg, grads)).items():
                        out[f"{tag}__grad__{k}"] = v.numpy()
                    for k, v in flat(lm.gather_params(cfg, new_p)).items():
                        out[f"{tag}__new__{k}"] = v.numpy()
                    eng = Engine(cfg, params, s_max=job["s_max"])
                    out[tag + "__tokens"] = eng.generate(
                        prompts, job["n_new"], **kw).numpy()
                    if odd and list(dims) == [2, 2]:
                        out[tag + "__tokens_odd"] = eng.generate(
                            torch.from_numpy(inp["odd_prompts"]),
                            job["n_new"]).numpy()
                    ck = job.get("ckpt")
                    if ck and ck["arch"] == arch and list(dims) == ck["save"]:
                        CheckpointManager(ck["dir"]).save(
                            1, {"params": new_p, "opt": new_o},
                            shardings=lm.state_placements(cfg))
                if ck and ck["arch"] == arch and list(dims) == ck["restore"]:
                    _restore(ck, cfg, mesh, out, flat)
        np.savez(f"{job['out']}_{rank}.npz", **out)
        dist.destroy_process_group()


    def _restore(ck, cfg, mesh, out, flat):
        # the 2 x 2 checkpoint, once it is published, at this mesh
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.models import lm
        from repro_torch.sharding.env import use_mesh
        from repro_torch.train import optimizer as TO
        done = os.path.join(ck["dir"], "step-000000001", "manifest.json")
        deadline = time.monotonic() + 300
        while not os.path.exists(done):
            if time.monotonic() > deadline:
                raise TimeoutError("no checkpoint from the 2 x 2 run")
            time.sleep(0.2)
        with use_mesh(mesh, mesh.connect("cpu")):
            tmpl = {"params": lm.init_params(
                        cfg, torch.Generator().manual_seed(0), "cpu"),
                    "opt": None}
            tmpl["opt"] = TO.init_opt_state(tmpl["params"])
            got = CheckpointManager(ck["dir"]).restore(
                tmpl, device="cpu", shardings=lm.state_placements(cfg))
            out["restored__step"] = got["opt"].step.numpy()
            for part, tree in (("params", got["params"]),
                               ("m", got["opt"].m), ("v", got["opt"].v)):
                for k, v in flat(lm.gather_params(cfg, tree)).items():
                    out[f"restored__{part}__{k}"] = v.numpy()


    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(worker, args=(world, sys.argv[2], json.loads(sys.argv[3])),
                 nprocs=world)
""")

LAUNCH_SCRIPT = textwrap.dedent("""
    import json, os, subprocess, sys
    ckpt, port = sys.argv[1], int(sys.argv[2])
    base = [sys.executable, "-m", "torch.distributed.run",
            "--nproc-per-node", "2", "--master-addr", "127.0.0.1"]
    train = ["-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
             "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt]
    runs = {}
    for name, extra, p in (
            ("first", ["--mesh", "1x2", "--backend", "gloo", "--steps", "2"],
             port),
            ("resume", ["--mesh", "1x2", "--backend", "gloo", "--steps",
                        "4"], port + 1),
            ("bad_mesh", ["--mesh", "2x2", "--backend", "gloo", "--steps",
                          "1"], port + 2),
            ("bad_backend", ["--mesh", "1x2", "--steps", "1"], port + 3)):
        r = subprocess.run(base + ["--master-port", str(p)] + train + extra,
                           capture_output=True, text=True, timeout=240)
        runs[name] = [r.returncode, r.stdout[-3000:], r.stderr[-6000:]]
    print("LAUNCH " + json.dumps(runs))
""")


def _finish(procs: dict) -> dict:
    """Wait for every subprocess of ``procs`` within TIMEOUT; fail with the
    output of the first that timed out or exited non-zero; return each
    one's stdout. No subprocess (nor a rank it spawned) is left running."""
    import signal
    import subprocess
    deadline = time.monotonic() + TIMEOUT
    outs = {}
    try:
        for what, proc in procs.items():
            try:
                out, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                out, err = proc.communicate()
                pytest.fail(f"{what} timed out after {TIMEOUT} s:\n"
                            f"{err[-3000:]}")
            assert proc.returncode == 0, f"{what} exited " \
                f"{proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}"
            outs[what] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return outs


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference (a subprocess per family), the port at worlds 2
    and 4, and the launcher runs together; wait for all; return
    (reference {family: {mesh: outputs}}, port {world: [rank outputs]},
    launcher {run: [rc, stdout, stderr]}, the checkpoint's directory,
    {family: its weights' .npz})."""
    tmp = tmp_path_factory.mktemp("sharded_lm")
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT)
    weights = {}
    prompts = np.random.default_rng(7).integers(
        0, 512, (PROMPTS, PROMPT_LEN)).astype(np.int64)
    for i, (fam, arch) in enumerate(FAMILIES.items()):
        w = _np_weights(arch, seed=100 + i)
        path = str(tmp / f"weights_{fam}.npz")
        extra = {}
        cfg = TC.get_config(arch, smoke=True)
        if fam == "moe":
            extra["odd_prompts"] = np.full(ODD_PROMPTS, 7, np.int64)
        if cfg.family == "encdec":   # bfloat16 values, so both cast exactly
            extra["frames"] = (torch.from_numpy(0.02 * np.random.default_rng(
                8).standard_normal((PROMPTS, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32))
                .to(torch.bfloat16).float().numpy())
        np.savez(path, prompts=prompts, **extra,
                 **{"w__" + k: v for k, v in _flat(w).items()})
        weights[fam] = path
    procs = {}
    for fam, arch in FAMILIES.items():
        procs[f"reference {fam}"] = start(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(
                [arch, weights[fam], str(tmp / f"ref_{fam}"),
                 FAMILY_MESHES[fam],
                 BATCH, SEQ, S_MAX, N_NEW, fam in F32,
                 fam == "moe"])])
    ckpt = str(tmp / "ckpt")
    for world, meshes in WORLD_MESHES.items():
        job = {"runs": [[FAMILIES[f], weights[f],
                         [m for m in meshes if m in FAMILY_MESHES[f]],
                         f in F32, f == "moe"]
                        for f in FAMILIES],
               "out": str(tmp / f"port_{world}"), "batch": BATCH,
               "seq": SEQ, "s_max": S_MAX, "n_new": N_NEW,
               "ckpt": {"arch": FAMILIES["dense"], "dir": ckpt,
                        "save": [2, 2], "restore": [1, 2]}}
        procs[f"port world {world}"] = start(
            [sys.executable, str(script), str(world), str(tmp / f"rdzv_{world}"),
             json.dumps(job)])
    launch = start([sys.executable, "-c", LAUNCH_SCRIPT,
                    str(tmp / "launch_ckpt"), str(_free_port())])
    procs["launcher"] = launch
    t0 = time.monotonic()
    outs = _finish(procs)
    print(f"sharded_lm subprocesses: {time.monotonic() - t0:.1f} s")
    ref = {fam: {_mesh_name(m): dict(np.load(
        tmp / f"ref_{fam}_{_mesh_name(m)}.npz")) for m in FAMILY_MESHES[fam]}
        for fam in FAMILIES}
    port = {w: [dict(np.load(tmp / f"port_{w}_{r}.npz")) for r in range(w)]
            for w in WORLD_MESHES}
    line = [ln for ln in outs["launcher"].splitlines()
            if ln.startswith("LAUNCH ")]
    assert line, outs["launcher"][-3000:]
    return ref, port, json.loads(line[0][7:]), ckpt, weights


CASES = [(f, _mesh_name(m)) for f in FAMILIES for m in FAMILY_MESHES[f]]


def _port(runs, mesh: str) -> list:
    world = 4 if mesh == "2x2" else 2
    return runs[1][world]


def _tag(fam, mesh):
    return f"{FAMILIES[fam]}_{mesh}"


def _same_on_every_rank(ranks, key):
    for r, out in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(out[key], ranks[0][key],
                                      err_msg=f"rank {r} differs: {key}")
    return ranks[0][key]


def _leaves(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _unflat(flat: dict, shapes, prefix=""):
    if isinstance(shapes, dict):
        return {k: _unflat(flat, v, f"{prefix}{k}__")
                for k, v in shapes.items()}
    return torch.from_numpy(np.asarray(flat[prefix[:-2]], np.float32))


def _one_device_update(fam: str, weights: str, grads: dict) -> dict:
    """The port's AdamW step off any mesh (``apply_updates``) from the
    family's initial weights on ``grads`` (flat gathered leaves): the
    new weights, flat."""
    cfg = TC.get_config(FAMILIES[fam], smoke=True)
    shapes = TL.param_shapes(cfg)
    inp = np.load(weights)
    params = _unflat({k[3:]: inp[k] for k in inp.files
                      if k.startswith("w__")}, shapes)
    new, _, _ = TO.apply_updates(TO.AdamWConfig(), params,
                                 _unflat(grads, shapes),
                                 TO.init_opt_state(params))
    return _flat(TL.params_to_numpy(new))


@pytest.mark.parametrize("fam,mesh", CASES)
def test_train_step_matches_reference_at_the_same_mesh(runs, fam, mesh):
    ref = runs[0][fam][mesh]
    ranks = _port(runs, mesh)
    tag = _tag(fam, mesh)
    got = lambda k: float(_same_on_every_rank(ranks, f"{tag}__metric__{k}"))
    want = lambda k: float(ref[f"metric__{k}"])
    assert got("ntok") == want("ntok") == BATCH * SEQ
    assert abs(got("loss") - want("loss")) <= LOSS_REL * abs(want("loss"))
    if fam in ("moe", "hybrid", "mla"):
        assert abs(got("aux") - want("aux")) <= AUX_REL * want("aux")
    else:
        assert got("aux") == want("aux") == 0.0
    assert abs(got("grad_norm") - want("grad_norm")) \
        <= GRAD_REL * want("grad_norm")
    assert abs(got("lr") - want("lr")) <= 1e-6 * want("lr")
    lr = want("lr")
    assert NEW_ABS < lr / 2
    one = _one_device_update(fam, runs[4][fam],
                             _leaves(ranks[0], f"{tag}__grad__"))
    for r, out in enumerate(ranks):
        new = _leaves(out, f"{tag}__new__")
        assert set(new) == set(one)
        for k, w in one.items():
            err = np.abs(new[k] - w).max()
            assert err <= NEW_ABS, (r, k, err)
    for part, bound in (("grad", None), ("new", lr)):
        g = _leaves(ranks[0], f"{tag}__{part}__")
        w = _leaves(ref, f"{part}__")
        assert set(g) == set(w) and g
        for k in w:
            a, b = g[k].astype(np.float32), w[k].astype(np.float32)
            assert a.shape == b.shape, (part, k)
            err, scale = np.abs(a - b).max(), np.abs(b).max()
            limit = (GRAD_REL * scale if bound is None
                     else 2.02 * bound + 1e-6 * scale)
            assert err <= max(limit, 1e-30), (part, k, err, scale)


@pytest.mark.parametrize("fam,mesh", CASES)
def test_generate_matches_reference_at_the_same_mesh(runs, fam, mesh):
    got = _same_on_every_rank(_port(runs, mesh), f"{_tag(fam, mesh)}__tokens")
    np.testing.assert_array_equal(got, runs[0][fam][mesh]["tokens"])


def test_moe_serves_a_batch_dp_does_not_divide(runs):
    got = _same_on_every_rank(_port(runs, "2x2"),
                              f"{_tag('moe', '2x2')}__tokens_odd")
    assert got.shape == (ODD_PROMPTS[0], N_NEW)
    np.testing.assert_array_equal(got, runs[0]["moe"]["2x2"]["tokens_odd"])


@pytest.mark.parametrize("fam,mesh", CASES)
def test_resident_bytes_equal_shard_bytes(runs, fam, mesh):
    """Parameters and both moments: each rank holds what the dry run's
    ``shard_bytes`` prices at its mesh, which is less than the whole."""
    tag = _tag(fam, mesh)
    whole = sum(v.size * 4 for k, v in runs[0][fam][mesh].items()
                if k.startswith("new__"))
    for out in _port(runs, mesh):
        want = int(out[tag + "__want_bytes"])
        assert want < whole
        for part in ("param", "m", "v"):
            assert int(out[f"{tag}__{part}_bytes"]) == want, part


EXPERTS = ("w_gate", "w_up", "w_down")


def _expert_gap(a: dict, pa: str, b: dict, pb: str) -> float:
    """The largest gap between two runs' routed-expert gradients, relative
    to the second's largest |value|, over every MoE layer."""
    gaps = [np.abs(a[pa + k] - b[pb + k]).max() / np.abs(b[pb + k]).max()
            for k in (k[len(pb):] for k in b if k.startswith(pb))
            if "__ffn__" in k and k.rsplit("__", 1)[-1] in EXPERTS]
    assert gaps
    return max(gaps)


def test_moe_capacity_follows_the_dp_local_tokens(runs):
    """The reference's 2 x 2 step routes each dp block's 64 tokens with a
    capacity of their own and drops other pairs than its 1 x 2 step,
    whose capacity is set by all 128, so their experts' gradients differ
    by far more than GRAD_REL; the port's are the reference's at its own
    mesh and not the other's."""
    ref = runs[0]["moe"]
    assert _expert_gap(ref["2x2"], "grad__", ref["1x2"], "grad__") \
        > 4 * GRAD_REL
    for m, other in (("2x2", "1x2"), ("1x2", "2x2")):
        port = _port(runs, m)[0]
        mine = f"{_tag('moe', m)}__grad__"
        assert _expert_gap(port, mine, ref[m], "grad__") <= GRAD_REL
        assert _expert_gap(port, mine, ref[other], "grad__") > GRAD_REL


def test_every_rank_raises_on_a_mesh_of_another_size(runs):
    for world, ranks in runs[1].items():
        for out in ranks:
            msg = str(out["mesh_error"])
            assert "needs a live process group" in msg, msg
            assert f"got {world}" in msg, msg


def _dense_step_bytes(dims) -> dict:
    """What one dense (qwen3-0.6b SMOKE) train step moves by kind on a
    (data, model) mesh of 2 x 1 or 1 x 2, counted from the model's shapes
    in ``collectives.BYTES``' convention (an all-reduce twice its tensor).

    2 x 1 (fsdp): every fsdp leaf is gathered whole: the tied embedding
    once, each block's leaves in the forward and again in the remat
    recompute; each is reduce-scattered once; the replicated leaves'
    gradients are all-reduced over dp, and so are five scalars: the token
    count, the loss, the aux, and the squared norms of the two norm
    buckets split over "data".
    1 x 2 (tp): each block's regions all-reduce a [B, S, d] bfloat16
    activation: attention its output, again in the remat recompute, and
    its input's gradient; the MLP its output and its input's gradient, not
    in the recompute, which stops once it has rebuilt what the backward
    saved (torch's non-reentrant checkpoint), before the block's last
    all-reduce. Besides, the embedding's output and the
    logits' input gradient once each; the cross-entropy's max, sum of
    exponentials and target logit, [B, S] float32; the gradients of the
    leaves attention uses whole on both ranks (wk, wv, q_norm, k_norm);
    and one squared-norm bucket split over "model"."""
    cfg = TC.get_config("qwen3-0.6b", smoke=True)
    r, d, dh, f = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    h, kv, v = cfg.n_heads, cfg.n_kv, TL.vocab_pad(cfg)
    assert cfg.tie_embeddings and cfg.qk_norm and not cfg.qkv_bias
    f32, bf16 = 4, 2
    embed = v * d * f32
    blocks = r * f32 * (2 * d * h * dh + 2 * d * kv * dh + 3 * d * f)
    replicated = f32 * (2 * r * d + 2 * r * dh + d)
    if dims == (2, 1):
        return {"all-gather": embed + 2 * blocks,
                "reduce-scatter": embed + blocks,
                "all-reduce": 2 * replicated + 2 * f32 * 5}
    act = BATCH * SEQ * d * bf16
    whole = r * f32 * (2 * d * kv * dh + 2 * dh)
    return {"all-gather": 0, "reduce-scatter": 0,
            "all-reduce": 2 * (r * 5 * act + 2 * act
                               + 3 * BATCH * SEQ * f32 + whole + f32)}


@pytest.mark.parametrize("dims", [(2, 1), (1, 2)])
def test_collective_bytes_of_a_dense_step(runs, dims):
    tag = _tag("dense", _mesh_name(dims))
    want = _dense_step_bytes(dims)
    for out in runs[1][2]:
        got = {k: int(out[f"{tag}__bytes__{k}"]) for k in want}
        assert got == want


def _full_template():
    cfg = TC.get_config(FAMILIES["dense"], smoke=True)
    zeros = lambda s: torch.zeros(s) if isinstance(s, tuple) else {
        k: zeros(v) for k, v in s.items()}
    params = zeros(TL.param_shapes(cfg))
    return {"params": params, "opt": TO.init_opt_state(params)}


def test_checkpoint_written_at_2x2_restores_at_1x2_and_on_one_device(runs):
    """Rank 0 of the 2 x 2 run wrote full leaves: on one device they are
    the run's gathered parameters bit for bit, and the 1 x 2 ranks'
    restore, gathered, is the one-device restore, leaf for leaf, moments
    and step too."""
    _, port, _, ckpt, _ = runs
    one = TCk.CheckpointManager(ckpt).restore(_full_template(), device="cpu")
    assert int(one["opt"].step) == 1
    trained = _leaves(port[4][0], f"{_tag('dense', '2x2')}__new__")
    got = _flat(TL.params_to_numpy(one["params"]))
    assert set(got) == set(trained)
    for k in trained:
        np.testing.assert_array_equal(got[k], trained[k], err_msg=k)
    for out in port[2]:
        assert int(out["restored__step"]) == 1
        for part, tree in (("params", one["params"]), ("m", one["opt"].m),
                           ("v", one["opt"].v)):
            for k, want in _flat(TL.params_to_numpy(tree)).items():
                np.testing.assert_array_equal(
                    out[f"restored__{part}__{k}"], want, err_msg=(part, k))


def test_reference_checkpoint_manager_reads_the_sharded_checkpoint(runs):
    ckpt = runs[3]
    tmpl = _full_template()
    mine = TCk.CheckpointManager(ckpt).restore(tmpl, device="cpu")
    np_tmpl = {"params": TL.params_to_numpy(tmpl["params"]),
               "opt": RO.OptState(np.zeros((), np.int32),
                                  TL.params_to_numpy(tmpl["opt"].m),
                                  TL.params_to_numpy(tmpl["opt"].v))}
    ref = RC.CheckpointManager(ckpt).restore(np_tmpl)
    assert int(ref["opt"].step) == int(mine["opt"].step) == 1
    for part, a, b in (("params", ref["params"], mine["params"]),
                       ("m", ref["opt"].m, mine["opt"].m),
                       ("v", ref["opt"].v, mine["opt"].v)):
        want = _flat(TL.params_to_numpy(b))
        got = _flat(a)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=(part, k))


def test_launcher_resumes_from_its_own_checkpoint(runs):
    """``launch.train --mesh 1x2 --backend gloo`` under two processes: the
    first run trains 2 steps and writes its checkpoint; the second, asked
    for 4, resumes from step 2. Rank 0 alone prints."""
    launch = runs[2]
    for name in ("first", "resume"):
        rc, out, err = launch[name]
        assert rc == 0, err
        assert out.count("done; checkpoint at") == 1, out
    assert "resumed" not in launch["first"][1]
    assert launch["resume"][1].count("resumed from step 2") == 1


def test_launcher_refuses_a_mesh_or_backend_that_does_not_fit(runs):
    """A 2 x 2 mesh on two processes raises the mesh's own error; the
    default backend, NCCL, on the CPU raises torch's own. Neither is
    replaced by anything that runs."""
    launch = runs[2]
    rc, _, err = launch["bad_mesh"]
    assert rc != 0 and "needs a live process group of 4 ranks, got 2" in err
    rc, _, err = launch["bad_backend"]
    assert rc != 0 and "nccl" in err.lower()
