"""repro_torch's multi-device DFEP and ETSCH over ``torch.distributed``
against repro's ``shard_map`` versions.

The reference runs in a subprocess with ``XLA_FLAGS`` asking for 4 host
devices (meshes of 1, 2 and 4 of them); the port runs ``n`` gloo ranks on
the CPU in a subprocess per world size (``torch.multiprocessing.spawn``,
rendezvous through a file under ``tmp_path``). All of them start together
in one module fixture and each writes its outputs to an ``.npz``; the tests
compare those. Both packages get the same start vertices (the reference's
``jax.random.choice``) and the ETSCH runs the same DFEP owner array.
``shard_graph`` is host numpy and is compared in this process.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax

from repro.core import dfep_distributed as RDD
from repro.core import graph as RG
from repro_torch.core import dfep as TD
from repro_torch.core import dfep_distributed as TDD
from repro_torch.core import graph as TG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 6
WORLDS = (1, 2, 4)
#: (world, variant_c, max_rounds): full runs, DFEP-C, and a run cut after
#: 5 rounds so that finalize assigns the rest.
DFEP_CASES = ((2, False, 10_000), (4, False, 10_000), (2, True, 10_000),
              (4, True, 10_000), (4, False, 5))
PR_ITERS = 20
#: The reference's own bound for sharded PageRank against its oracle
#: (tests/test_distributed.py): the same float32 sums in another order.
PR_RTOL = 1e-5
#: Seconds the subprocesses of a fixture may take together; the whole file
#: takes far less.
TIMEOUT = 300


def _graphs():
    ref = RG.watts_strogatz(600, 6, 0.1, seed=3)
    return ref, TG.graph_from_numpy(ref, device="cpu")


def _case_name(world, variant_c, max_rounds) -> str:
    return f"n{world}_{'c' if variant_c else 'plain'}_r{max_rounds}"


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.core import dfep, dfep_distributed, etsch, etsch_distributed
    from repro.core import graph

    inputs, out_path = sys.argv[1], sys.argv[2]
    cases = eval(sys.argv[3])
    worlds = eval(sys.argv[4])
    iters = int(sys.argv[5])
    inp = np.load(inputs)
    g = graph.watts_strogatz(600, 6, 0.1, seed=3)
    k = int(inp["k"])

    def mesh(n):
        return Mesh(np.array(jax.devices()[:n]), ("data",))

    out = {}
    for name, (n, vc, mr) in cases.items():
        cfg = dfep.DfepConfig(k=k, variant_c=vc, max_rounds=mr)
        owner, info = dfep_distributed.run_dfep_sharded(
            g, cfg, jax.random.key(0), mesh(n))
        out[name + "_owner"] = np.asarray(owner)
        out[name + "_info"] = np.array([info["rounds"],
                                        info["unsold_at_stop"],
                                        info["finalized"], info["ndev"]])
    part = etsch.compile_partitioning(g, inp["owner"], k)
    for n in worlds:
        dist, steps = etsch_distributed.sssp_sharded(part, 0, mesh(n))
        out[f"sssp_{n}"] = np.asarray(dist)
        out[f"sssp_{n}_steps"] = np.array(steps)
        pr = etsch_distributed.pagerank_sharded(part, g.degrees(), mesh(n),
                                                iters=iters)
        out[f"pr_{n}"] = np.asarray(pr)
    np.savez(out_path, **out)
""")

PORT_SCRIPT = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, world, rdzv, inputs, out_dir, cases, iters):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + rdzv,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        from repro_torch.core import (dfep, dfep_distributed, etsch,
                                      etsch_distributed, graph)
        inp = np.load(inputs)
        g = graph.watts_strogatz(600, 6, 0.1, seed=3, device="cpu")
        k = int(inp["k"])
        out = {}
        for name, (n, vc, mr) in cases.items():
            if n != world:
                continue
            cfg = dfep.DfepConfig(k=k, variant_c=vc, max_rounds=mr)
            owner, info = dfep_distributed.run_dfep_sharded(
                g, cfg, inp["starts"], device="cpu")
            out[name + "_owner"] = owner.numpy()
            out[name + "_info"] = np.array([info["rounds"],
                                            info["unsold_at_stop"],
                                            info["finalized"],
                                            info["ndev"]])
        part = etsch.compile_partitioning(g, inp["owner"], k, device="cpu")
        d, steps = etsch_distributed.sssp_sharded(part, 0)
        out[f"sssp_{world}"] = d.numpy()
        out[f"sssp_{world}_steps"] = np.array(steps)
        pr = etsch_distributed.pagerank_sharded(part, g.degrees(),
                                                iters=iters)
        out[f"pr_{world}"] = pr.numpy()
        np.savez(f"{out_dir}/port_{world}_{rank}.npz", **out)
        dist.destroy_process_group()


    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(worker, args=(world, sys.argv[2], sys.argv[3], sys.argv[4],
                               eval(sys.argv[5]), int(sys.argv[6])),
                 nprocs=world)
""")


def start(cmd):
    """A subprocess of the repository in its own session (so that a
    timeout kills its ranks too), with one thread a process and no
    inherited XLA_FLAGS."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def finish(procs: dict) -> None:
    """Wait for every subprocess of ``procs`` (name -> Popen), all within
    TIMEOUT; fail with the output of the first that timed out or exited
    non-zero. Whatever way this returns, no subprocess (nor any rank it
    spawned) is left running: their sessions are killed."""
    deadline = time.monotonic() + TIMEOUT
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
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


def same_on_every_rank(ranks: list, key: str) -> np.ndarray:
    """A port output, after checking that every rank returned the same."""
    for r, out in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(out[key], ranks[0][key],
                                      err_msg=f"rank {r} differs: {key}")
    return ranks[0][key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference and one port run per world size together; wait
    for all of them; return (reference outputs, {world: [rank outputs]})."""
    tmp = tmp_path_factory.mktemp("dfep_dist")
    ref_g, tg = _graphs()
    starts = np.asarray(jax.random.choice(jax.random.key(0), ref_g.n_vertices,
                                          shape=(K,), replace=False))
    owner, _ = TD.partition(tg, K, starts=starts, device="cpu")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, k=K, starts=starts, owner=owner.numpy())
    cases = {_case_name(*c): c for c in DFEP_CASES}
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT)
    procs = {"reference": start(
        [sys.executable, "-c", REF_SCRIPT, inputs, str(tmp / "ref.npz"),
         repr(cases), repr(WORLDS), str(PR_ITERS)])}
    for n in WORLDS:
        procs[f"port world {n}"] = start(
            [sys.executable, str(script), str(n), str(tmp / f"rdzv_{n}"),
             inputs, str(tmp), repr(cases), str(PR_ITERS)])
    finish(procs)
    port = {n: [dict(np.load(tmp / f"port_{n}_{r}.npz")) for r in range(n)]
            for n in WORLDS}
    return dict(np.load(tmp / "ref.npz")), port


def _port(runs, world: int, key: str) -> np.ndarray:
    return same_on_every_rank(runs[1][world], key)


@pytest.mark.parametrize("ndev", (1, 2, 3, 8))
def test_shard_graph_matches_reference(ndev):
    ref_g, tg = _graphs()
    want = RDD.shard_graph(ref_g, ndev)
    got = TDD.shard_graph(tg, ndev)
    assert got._fields == want._fields
    for name in want._fields:
        w, x = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert x.dtype == w.dtype, name
        np.testing.assert_array_equal(x, w, err_msg=name)


@pytest.mark.parametrize("case", DFEP_CASES,
                         ids=[_case_name(*c) for c in DFEP_CASES])
def test_run_dfep_sharded_matches_reference(runs, case):
    name = _case_name(*case)
    ref, _ = runs
    owner = _port(runs, case[0], name + "_owner")
    np.testing.assert_array_equal(owner, ref[name + "_owner"])
    # rounds, unsold_at_stop, finalized, ndev
    np.testing.assert_array_equal(_port(runs, case[0], name + "_info"),
                                  ref[name + "_info"])
    if case[2] == 5:
        assert ref[name + "_info"][2], "the capped run must finalize"


@pytest.mark.parametrize("world", WORLDS)
def test_sssp_sharded_matches_reference(runs, world):
    """Bit-identical distances and equal supersteps; at 4 ranks K = 6 is
    padded to 8 with empty partitions."""
    ref, _ = runs
    np.testing.assert_array_equal(_port(runs, world, f"sssp_{world}"),
                                  ref[f"sssp_{world}"])
    assert int(_port(runs, world, f"sssp_{world}_steps")) == \
        int(ref[f"sssp_{world}_steps"])


@pytest.mark.parametrize("world", WORLDS)
def test_pagerank_sharded_matches_reference(runs, world):
    ref, _ = runs
    np.testing.assert_allclose(_port(runs, world, f"pr_{world}"),
                               ref[f"pr_{world}"], rtol=PR_RTOL)


def test_sharded_entry_points_need_a_process_group():
    """Without an initialised process group a sharded entry point raises;
    it never runs as one rank."""
    _, tg = _graphs()
    with pytest.raises(RuntimeError, match="process group"):
        TDD.run_dfep_sharded(tg, TD.DfepConfig(k=K), list(range(K)),
                             device="cpu")
    assert not torch.distributed.is_initialized()
