"""Time the design choices of segment_reduce, gspmm, minplus_sweep,
selective_scan, the replica exchange, selective_scan_bwd and
masked_update on one GPU, and, with ``--parent``, the kernels they
replaced, in the same process.

    python3 tools/probe_kernels.py [--parent DIR] [--twin DIR]
                                   [--scan-bwd-variant NAME[,...]]
                                   [--only NAME,...]

segment_reduce: on the main path's plan (dblp 1.0 partitioned by DFEP, K =
16, 4000 rounds, as ``chip_smoke.py``'s main phase), min over SSSP-like
messages (~20% +inf) and add over finite ones, held to the plain version
(min exact, add within ``chip_smoke.SEG_ADD_RTOL``), timed with the plan's
layout and with layouts built under each of SEG_VARIANTS (other tile sizes
and run-kind thresholds), and, to show where the time goes, with parts of
the layout taken away (only the tiles; only the units; every block
launched with nothing to do) beside one empty kernel's launch; the
layout's build (which ``compile_plan`` makes on the card) is timed again.
gspmm: on the same plan, add with scalar weights at F = 8 and 128 and with
per-feature weights at F = 8 (kge_score's shape), held to the plain version
(``chip_smoke.GSPMM_ADD_RTOL``) and timed with the plan's layout and
mapping, with each of GS_MAPPINGS (lanes a slot, floats a load), with
layouts built under each of GS_VARIANTS (unit chunk sizes,
tile sizes, the unit threshold), and, to show where the time goes, with
parts of the layout taken away (only the tiles; only the units; every
block launched with nothing to do), and on the plans with only the
largest hub run live and with no live slot (``chip_smoke._hub_split``);
then, at F = 1, 4, 8, 32 and 128, the kernel, the kernel with no live
slot, and ``fill_`` of an output of that size.
minplus_sweep: on the same partition, ETSCH's flat [K·V] state (~20% +inf,
~5% of the live edges masked out), the whole graph's [V] state,
multi-source SSSP's [K·8·V] state, and usroads 1.0 partitioned the same
way (the flat shape of most ETSCH sweeps in ``chip_smoke.py``); each
exact against the plain version, timed with the default layout and with
each of VARIANTS (a tile size forced, other thresholds between the row
kinds), and, to show where the time goes, with parts of the layout taken
away (only the copy; the tiles without the units; no hubs) beside
``clone()`` of the state.
selective_scan: the falcon-mamba-7b prefill shape [4, 512, 8192, 16] from a
zero state and S = 1 from a random one, inputs drawn as ``chip_smoke.py``
draws them, held to ``chip_smoke.SCAN_REL`` of the plain loop.
exchange: on the main path's plan, at ``chip_smoke.EXCHANGE_CASES`` (F = 1
min and add, F = 8 add and max), the parent's chain (``exchange_ref``
closed by the ``masked_update`` kernel) in its parts (the mask, ``where``,
``full``, the index expand, ``scatter_reduce_``, ``masked_update``) and
whole, device and eager ms; ``replica_exchange`` held to the chain and to
its layout's plain walk and timed whole, with only its group pass or only
its slot pass, with its groups in EX_ORDERS, and in turns with the chain;
``fill_`` of its output; the layout's counts and build time; then warm
SSSP, WCC, PageRank(30), ``gcn_layer`` and ``kge_score`` with the
engine's exchange swapped for the chain and back, in turns (counters
equal).

selective_scan_bwd: at ``chip_smoke.TRAIN_SCAN_SHAPE`` and
``chip_smoke.SCAN_BWD_RAGGED``, inputs drawn as ``chip_smoke.py`` draws
them, each of the seven gradients held to ``chip_smoke.SCAN_GRAD_REL`` of
the plain version on the plain chunk states; at the training shape the
wrapper's device ms beside the bound, and with ``--parent`` (and
``--scan-bwd-variant NAME[,...]``: this tree's source patched as
``SCAN_BWD_VARIANTS`` says, written to ``build/variant/`` and built
there) the other builds in turns with this one. The variants are
ablations, not designs: each but ``warps8`` returns wrong gradients.
masked_update: on the main path's plan and on a world-2 rank's block
(``chip_smoke.DIST_BLOCK_WORLD``), at F = 1, 3, 8 and
``chip_smoke.SERVE_LANES``, exact against the plain version (min and
add, ~20% of the states +inf), device ms beside the bound and, with
``--parent``, in turns with the parent's kernel (held exact too).

``--parent DIR`` names a checkout of the commit before a redesign: its
``csrc/segment_reduce.cu`` (a memset, a thread per target, a block per
listed hub, an atomic append scatter), ``csrc/gspmm.cu`` (a memset, a lane
group per target, hub chunks listed by an atomic and combined by float
atomics, an append launch), ``csrc/minplus_sweep.cu`` and
``csrc/selective_scan.cu``, ``csrc/selective_scan_bwd.cu`` (a thread
walking all S steps) and ``csrc/masked_update.cu`` (the chain's update; a
thread an element) are built with nvcc into ``build/parent/`` and
called through their own C entry points, timed in the order parent, new,
new, parent; the parent's segment_reduce also on one target and one append
slot (its four device operations with almost no work). Device times are
CUDA-graph replays (``chip_smoke.device_ms``). ``--twin DIR`` names a
checkout whose ``csrc/gspmm.cu`` has this tree's C entry point (another
build of this design): it is built into ``build/twin/`` (its ``nvcc``
seconds logged) and timed in turns with this tree's at each gspmm case
(``twin_turns``: the twin's times under ``parent_ms``); so is its
``csrc/replica_exchange.cu`` at each exchange case. One JSON object
per line; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: Layout settings tried beside the defaults: label -> ops constants.
VARIANTS = {
    **{f"tile_{t}": {"MINPLUS_TILE_ROWS": (t,)} for t in (256, 512, 1024,
                                                          2048)},
    "short_4": {"MINPLUS_SHORT": 4},
    "short_16": {"MINPLUS_SHORT": 16},
    "warp_128": {"MINPLUS_WARP": 128},
    "warp_2048": {"MINPLUS_WARP": 2048},
    "hub_2048": {"MINPLUS_HUB": 2048},
    "hub_16384": {"MINPLUS_HUB": 16384},
}
#: segment_reduce layout settings tried beside the defaults: label ->
#: engine.kernels constants.
SEG_VARIANTS = {
    **{f"slots_{t}": {"SEG_TILE_SLOTS": t} for t in (1024, 1536, 3072)},
    "targets_1024": {"SEG_TILE_TARGETS": 1024},
    **{f"thread_{t}": {"SEG_THREAD": t} for t in (16, 64)},
    **{f"warp_{t}": {"SEG_WARP": t} for t in (256, 1024)},
    **{f"gap_{t}": {"SEG_GAP": t} for t in (8, 128)},
}
#: gspmm layout settings tried beside the defaults: label -> engine.kernels
#: constants (GS_CHUNK: a unit chunk's slots; SEG_WARP: the longest run a
#: tile keeps).
GS_VARIANTS = {
    **{f"chunk_{t}": {"GS_CHUNK": t} for t in (256, 1024, 2048, 8192)},
    **{f"slots_{t}": {"SEG_TILE_SLOTS": t} for t in (1024, 4096)},
    **{f"warp_{t}": {"SEG_WARP": t} for t in (128, 2048)},
}
#: gspmm mappings timed beside gspmm_mapping's, by width: (lanes a slot,
#: floats a load), each one of csrc/gspmm.cu's GSPMM_SHAPES; a row wider
#: than lanes·floats takes several passes.
GS_MAPPINGS = {1: [], 8: [(2, 4), (1, 4), (8, 1), (4, 1)],
               128: [(32, 4), (16, 4), (32, 1)]}
#: The replaced kernels' C entry points: (symbol, argtypes), each the one
#: before its kernel's last redesign: ``--parent`` with a probe takes a
#: checkout from before that kernel's redesign.
PARENT = {
    "segment_reduce": ("segment_reduce_f32", [_P] * 9 + [_I] * 6 + [_P]),
    "gspmm": ("gspmm_f32", [_P] * 11 + [_I] * 7 + [_P]),
    "minplus_sweep": ("minplus_sweep_f32",
                      [_P] * 5 + [_L, _L, ctypes.c_float, _P]),
    "selective_scan": ("selective_scan_f32", [_P] * 9 + [_I] * 4 + [_P]),
    "masked_update": ("masked_update_f32", [_P] * 6 + [_L, _I, _I,
                                                        ctypes.c_float, _P]),
    "selective_scan_bwd": ("selective_scan_bwd_f32",
                           [_P] * 16 + [_I] * 4 + [_P]),
}


#: The parent library a probe times where it is not the probe's own name:
#: the exchange's chain closes with the parent's masked_update.
PARENT_OF = {"exchange": "masked_update"}


def _parent_entries(parent: Path, names) -> dict:
    """The named kernels of PARENT, built from the checkout ``parent``."""
    out_dir = ROOT / "build" / "parent"
    fns = {}
    for name in names:
        symbol, argtypes = PARENT[name]
        lib = out_dir / f"{name}.so"
        _nvcc(parent / "src/repro_torch/csrc" / f"{name}.cu", lib)
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _nvcc(source: Path, lib: Path) -> float:
    """Build ``source`` into ``lib``; the seconds it took. The compiler's
    messages go to ``lib``.log."""
    from repro_torch import cuda_build
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    done = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib), str(source)],
                          check=True, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(done.stdout + done.stderr)
    return time.perf_counter() - t0


def _empty_kernel():
    """A kernel of one block that does nothing: one launch's floor."""
    src = ROOT / "build" / "probe" / "empty.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text('__global__ void empty_kernel() {}\n'
                   'extern "C" int empty_launch(void* stream) {\n'
                   '  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();\n'
                   '  return (int)cudaGetLastError();\n}\n')
    lib = src.with_suffix(".so")
    _nvcc(src, lib)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes, fn.restype = [_P], ctypes.c_int
    return fn


def _in_turns(parent_fn, new_fn) -> dict:
    """parent, new, new, parent: device ms of each."""
    p1, n1 = C.device_ms(parent_fn), C.device_ms(new_fn)
    n2, p2 = C.device_ms(new_fn), C.device_ms(parent_fn)
    return {"parent_ms": [p1, p2], "new_ms": [n1, n2]}


def _seg_launch(fn, plan, msgs, combine, lay, out):
    """One call of a segment_reduce C entry over ``lay``, as the wrapper
    makes it (``engine.kernels.segment_reduce``)."""
    from repro_torch.engine import kernels as Kn
    f = 1 if msgs.ndim == 2 else int(msgs.shape[2])
    vec = 4 if (plan.e_max * f) % 4 == 0 and msgs.data_ptr() % 16 == 0 \
        and plan.emask.data_ptr() % 4 == 0 else 1
    rc = fn(*[t.data_ptr() for t in (msgs, plan.emask, out, lay.tiles,
                                     lay.words, lay.warp_targets, lay.units,
                                     lay.app_ptr, lay.app_slots)],
            lay.n_tiles, lay.n_units, lay.window_cap, lay.tile_targets,
            lay.thread_max, lay.n_append, f, Kn._OP_CODE[combine], vec,
            torch.cuda.current_stream().cuda_stream)
    C.require(rc == 0, f"segment_reduce: CUDA error {rc}")
    return out


def probe_segment(g, owner, gen, parent) -> None:
    from repro_torch import cuda_build
    from repro_torch import engine as E
    from repro_torch.engine import kernels as Kn
    plan = E.compile_plan(g, owner, C.K)
    dev = plan.device
    dist = torch.rand(plan.emask.shape, generator=gen, device=dev) * 30
    dist = torch.where(torch.rand(plan.emask.shape, generator=gen,
                                  device=dev) < 0.2, float("inf"), dist)
    finite = torch.where(torch.isinf(dist), 1.0, dist) / 30
    base = Kn.segment_layout(plan)
    row = {"phase": "probe.segment_reduce", "layout": base.stats(),
           "longest_units": base.units[:8, 2].tolist(),
           "layout_build_s": C.wall(
               lambda: Kn.build_segment_layout(plan))[1],
           "bound_ms": C._seg_bound(plan)[0]}
    new = cuda_build.entry("segment_reduce")
    out = torch.empty((plan.k, plan.v_max, 1), device=dev)
    variants = {label: {} for label in SEG_VARIANTS}
    for label, setting in SEG_VARIANTS.items():
        saved = {key: getattr(Kn, key) for key in setting}
        for key, value in setting.items():
            setattr(Kn, key, value)
        variants[label] = Kn.build_segment_layout(plan)
        for key, value in saved.items():
            setattr(Kn, key, value)
    for combine, m in (("min", dist), ("add", finite)):
        want = Kn.segment_reduce_ref(plan, m, combine)

        def held(got, what):
            if combine == "min":
                C.require(torch.equal(got, want), f"{what} min not exact")
            else:
                rel = float(((got - want).abs()
                             / want.abs().clamp(min=1e-30)).max())
                C.require(rel <= C.SEG_ADD_RTOL, f"{what} add: {rel}")
        held(Kn.segment_reduce(plan, m, combine), "segment_reduce")
        row[f"{combine}_ms"] = C.device_ms(
            lambda: Kn.segment_reduce(plan, m, combine))
        for label, lay in variants.items():
            held(_seg_launch(new, plan, m, combine, lay, out)[:, :, 0],
                 label)
            row[f"{combine}_{label}_ms"] = C.device_ms(
                lambda: _seg_launch(new, plan, m, combine, lay, out))
        if parent is not None:
            old_fn = parent["segment_reduce"]
            work = torch.empty(1 + plan.k * plan.v_max, dtype=torch.int32,
                               device=dev)
            old_out = torch.empty_like(out)

            def old(k=plan.k, v=plan.v_max, lo=int(plan.csr_fill.min())):
                rc = old_fn(*[t.data_ptr() for t in (
                    m, plan.emask, plan.run_start, plan.last_slot,
                    plan.vmask, plan.edge_tgt, plan.csr_fill, old_out,
                    work)], k, plan.e_max, v, 1, lo, Kn._OP_CODE[combine],
                    torch.cuda.current_stream().cuda_stream)
                C.require(rc == 0, f"parent segment_reduce: CUDA error {rc}")
                return old_out
            old()
            held(old_out[:, :, 0], "parent segment_reduce")
            row[f"{combine}_turns"] = _in_turns(old, lambda: Kn.segment_reduce(
                plan, m, combine))
            if combine == "min":
                row["parent_chain_ms"] = C.device_ms(
                    lambda: old(k=1, v=1, lo=plan.e_max - 1))
    # where the time goes (min; timing only: those outputs are not whole)
    idle = base.tiles.clone()
    idle[:, [1, 3, 4, 5, 6, 7]] = 0
    parts = {"tiles_only": dataclasses.replace(base,
                                               units=base.units[:0]),
             "units_only": dataclasses.replace(base, tiles=base.tiles[:0]),
             "idle": dataclasses.replace(
                 base, tiles=idle, units=base.units * torch.tensor(
                     [1, 1, 0, 0], dtype=torch.int32, device=dev),
                 app_slots=base.app_slots[:0])}
    for label, lay in parts.items():
        row[f"{label}_ms"] = C.device_ms(
            lambda: _seg_launch(new, plan, dist, "min", lay, out))
    empty = _empty_kernel()
    stream = torch.cuda.current_stream

    def empty_call():
        C.require(empty(stream().cuda_stream) == 0, "empty kernel")
    row["empty_kernel_ms"] = C.device_ms(empty_call)
    C.log(row)


def _twin_entry(twin: Path, name: str):
    """Library ``name``'s C entry point built from the checkout ``twin``,
    whose ``csrc/<name>.cu`` has this tree's C interface, and the seconds
    its ``nvcc`` took."""
    from repro_torch import cuda_build
    lib = ROOT / "build" / "twin" / f"{name}.so"
    secs = _nvcc(twin / "src/repro_torch/csrc" / f"{name}.cu", lib)
    symbol, argtypes = cuda_build.SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, secs


def _variant_layouts(Kn, plan, variants) -> dict:
    """label -> the GspmmLayout built with that label's constants set."""
    out = {}
    for label, setting in variants.items():
        saved = {key: getattr(Kn, key) for key in setting}
        for key, value in setting.items():
            setattr(Kn, key, value)
        out[label] = Kn.build_gspmm_layout(plan, Kn.build_segment_layout(
            plan))
        for key, value in saved.items():
            setattr(Kn, key, value)
    return out


def probe_gspmm(g, owner, gen, parent, twin) -> None:
    from repro_torch import engine as E
    from repro_torch.engine import kernels as Kn
    plan = E.compile_plan(g, owner, C.K)
    dev = plan.device
    base = Kn.gspmm_layout(plan)
    variants = _variant_layouts(Kn, plan, GS_VARIANTS)
    _, hub_only, empty = C._hub_split(plan)
    # where the time goes (timing only: those outputs are not whole)
    seg = base.seg
    idle = seg.tiles.clone()
    idle[:, [1, 3, 4, 5, 6, 7]] = 0
    empty_chunks = base.chunks.clone()
    empty_chunks[:, 2] = 0
    empty_chunks[:, 5] = 1
    parts = {"tiles_only": dataclasses.replace(base,
                                               chunks=base.chunks[:0]),
             "units_only": dataclasses.replace(
                 base, seg=dataclasses.replace(seg, tiles=seg.tiles[:0])),
             "idle": dataclasses.replace(
                 base, chunks=empty_chunks, seg=dataclasses.replace(
                     seg, tiles=idle, app_slots=seg.app_slots[:0]))}
    C.log({"phase": "probe.gspmm.layout", "layout": seg.stats(),
           "chunks": base.n_chunks, "chunk_slots": base.chunk_slots,
           "longest_units": seg.units[:8, 2].tolist(),
           "layout_build_s": C.wall(lambda: Kn.build_gspmm_layout(
               plan, Kn.build_segment_layout(plan)))[1],
           "variants": {label: {"chunks": lay.n_chunks,
                                **lay.seg.stats()}
                        for label, lay in variants.items()}})
    cases = [("f1", 1, False), ("f8", 8, False), ("feature_f8", 8, True),
             ("f128", 128, False)]
    for name, f, per_feature in cases:
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        w = torch.rand(tuple(plan.emask.shape) + (f,), generator=gen,
                       device=dev) if per_feature else plan.edge_w
        want = Kn.gspmm_ref(plan, feats, w, "add")

        def held(got, what):
            rel = float(((got - want).abs()
                         / want.abs().clamp(min=1e-30)).max())
            C.require(rel <= C.GSPMM_ADD_RTOL, f"gspmm {name} {what}: {rel}")

        def launch(lay=base, mapping=None):
            return lambda: Kn._gspmm_launch(plan, lay, feats, w, "add",
                                            mapping)
        row = {"phase": "probe.gspmm", "case": name,
               "mapping": Kn.gspmm_mapping(f, f % 4 == 0),
               "bound_ms": C._gspmm_bound(plan, f, per_feature)[0]}
        held(Kn.gspmm(plan, feats, w, "add"), "default")
        row["kernel_ms"] = C.device_ms(lambda: Kn.gspmm(plan, feats, w,
                                                        "add"))
        if not per_feature:
            for m in GS_MAPPINGS[f]:
                held(launch(mapping=m)(), f"mapping {m}")
                row[f"map_{'_'.join(map(str, m))}_ms"] = C.device_ms(
                    launch(mapping=m))
            for label, lay in variants.items():
                held(launch(lay)(), label)
                row[f"{label}_ms"] = C.device_ms(launch(lay))
        for label, lay in parts.items():
            row[f"{label}_ms"] = C.device_ms(launch(lay))
        for label, p in (("hub_only", hub_only), ("empty", empty)):
            pw = w if per_feature else p.edge_w
            row[f"{label}_plan_ms"] = C.device_ms(
                lambda: Kn.gspmm(p, feats, pw, "add"))
        if parent is not None:
            old_fn = parent["gspmm"]
            work = torch.empty(1 + 3 * (plan.k * plan.e_max // 32),
                               dtype=torch.int32, device=dev)
            old_out = torch.empty_like(want)
            lo = int(plan.csr_fill.min())

            def old():
                rc = old_fn(*[t.data_ptr() for t in (
                    feats, w, plan.edge_nbr, plan.emask, plan.run_start,
                    plan.last_slot, plan.vmask, plan.edge_tgt, plan.csr_fill,
                    old_out, work)], plan.k, plan.e_max, plan.v_max, f,
                    int(per_feature), lo, Kn._OP_CODE["add"],
                    torch.cuda.current_stream().cuda_stream)
                C.require(rc == 0, f"parent gspmm: CUDA error {rc}")
                return old_out
            old()
            held(old_out, "parent")
            row["turns"] = _in_turns(old, lambda: Kn.gspmm(plan, feats, w,
                                                           "add"))
        if twin is not None:
            def other():
                out, args = Kn._gspmm_args(plan, base, feats, w, "add")
                rc = twin(*args)
                C.require(rc == 0, f"twin gspmm: CUDA error {rc}")
                return out
            held(other(), "twin")
            row["twin_turns"] = _in_turns(other, lambda: Kn.gspmm(
                plan, feats, w, "add"))
        C.log(row)
        del feats, want
    # time against width: the kernel, the kernel with no live slot (its
    # walk and its writes), and writing an output of that size (fill_)
    row = {"phase": "probe.gspmm.widths"}
    for f in (1, 4, 8, 32, 128):
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        out = torch.empty_like(feats)
        row[f"f{f}"] = {
            "kernel_ms": C.device_ms(lambda: Kn.gspmm(plan, feats,
                                                      plan.edge_w, "add")),
            "empty_ms": C.device_ms(lambda: Kn.gspmm(empty, feats,
                                                     empty.edge_w, "add")),
            "fill_ms": C.device_ms(lambda: out.fill_(0.0))}
        del feats, out
    C.log(row)


def probe_minplus(g, owner, gen, parent) -> None:
    from repro_torch.core import dfep, etsch, graph
    from repro_torch.kernels import ops, ref
    part = etsch.compile_partitioning(g, owner, C.K)
    road = graph.load_dataset("usroads", scale=1.0, seed=C.SEED)
    road_owner, _ = dfep.partition(road, k=C.K, seed=C.SEED,
                                   max_rounds=4000, stall_rounds=64)
    rpart = etsch.compile_partitioning(road, road_owner, C.K)
    kv, s_n = part.k * part.n_vertices, C.N_SOURCES
    dev = part.device

    def state(n):
        x = torch.rand(n, generator=gen, device=dev) * 30
        return torch.where(torch.rand(n, generator=gen, device=dev) < 0.2,
                           float("inf"), x)

    def thin(mask):
        return mask & (torch.rand(mask.shape, generator=gen, device=dev)
                       >= 0.05)

    mask = thin(part.flat_mask)
    shapes = {
        "etsch": (state(kv), part.flat_src, part.flat_dst, mask, kv,
                  part.k, 1),
        "graph": (state(g.n_vertices), g.src, g.dst, thin(g.edge_mask),
                  g.n_vertices, 1, 1),
        "multi_source": (state(kv * s_n), part.flat_src, part.flat_dst,
                         mask, kv, part.k, s_n),
        "usroads": (state(rpart.k * rpart.n_vertices), rpart.flat_src,
                    rpart.flat_dst, thin(rpart.flat_mask),
                    rpart.k * rpart.n_vertices, rpart.k, 1),
    }
    for name, (dist, src, dst, m, rows, groups, reps) in shapes.items():
        base = ops.minplus_layout(src, dst, rows, groups).with_replicas(reps)
        e_src, e_dst, e_mask = base.replicate(src, dst, m)
        want = ref.minplus_relax(dist, e_src, e_dst, e_mask)
        row = {"phase": "probe.minplus_sweep", "shape": name,
               "rows": rows * reps, "half_edges": base.half_edges.shape[0],
               "units": list(base.counts),
               "bound_ms": C._minplus_bound(m, rows * reps, reps)[0]}
        row["default_ms"] = C.device_ms(
            lambda: ops.minplus_sweep(dist, src, dst, m, layout=base))
        for label, setting in VARIANTS.items():
            saved = {key: getattr(ops, key) for key in setting}
            for key, value in setting.items():
                setattr(ops, key, value)
            lay = ops.minplus_layout(src, dst, rows, groups)
            lay = lay.with_replicas(reps)
            for key, value in saved.items():
                setattr(ops, key, value)
            got = ops.minplus_sweep(dist, src, dst, m, layout=lay)
            C.require(torch.equal(got, want), f"minplus {name} {label}")
            row[f"{label}_ms"] = C.device_ms(
                lambda: ops.minplus_sweep(dist, src, dst, m, layout=lay))
        # where the time goes: the same launch with parts of the layout
        # taken away (timing only: those outputs are not whole)
        empty = torch.zeros_like(base.tile_ptr)
        parts = {"copy_only": dataclasses.replace(
                     base, tile_ptr=empty, counts=(0, 0, 0)),
                 "tiles_only": dataclasses.replace(base, counts=(0, 0, 0)),
                 "no_hubs": dataclasses.replace(
                     base, rows=base.rows[base.counts[0]:].contiguous(),
                     counts=(0,) + base.counts[1:])}
        for label, lay in parts.items():
            row[f"{label}_ms"] = C.device_ms(
                lambda: ops.minplus_sweep(dist, src, dst, m, layout=lay))
        row["clone_ms"] = C.device_ms(lambda: dist.clone())
        if parent is not None:
            fn, out = parent["minplus_sweep"], torch.empty_like(dist)
            s32, d32 = e_src.int().contiguous(), e_dst.int().contiguous()
            e_mask = e_mask.contiguous()

            def old():
                rc = fn(dist.data_ptr(), s32.data_ptr(), d32.data_ptr(),
                        e_mask.data_ptr(), out.data_ptr(), dist.numel(),
                        s32.numel(), 1.0, torch.cuda.current_stream()
                        .cuda_stream)
                C.require(rc == 0, f"parent minplus_sweep: CUDA error {rc}")
                return out
            old()
            C.require(torch.equal(out, want), f"parent minplus {name}")
            row.update(_in_turns(old, lambda: ops.minplus_sweep(
                dist, src, dst, m, layout=base)))
        C.log(row)


def probe_scan(gen, parent) -> None:
    from repro_torch.kernels import ops, ref
    b, s, d, n = 4, 512, 8192, 16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, bb, cc = randn(b, s, d), randn(b, s, n, scale=0.5), \
        randn(b, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    a = torch.exp(randn(d, n, scale=0.3))
    dsk, h0 = randn(d), randn(b, d, n)
    cases = {"prefill": (x, dt, bb, cc, a, dsk, None),
             "decode": tuple(t[:, :1].contiguous() for t in (x, dt, bb, cc))
             + (a, dsk, h0)}
    for name, args in cases.items():
        want = ref.selective_scan_ref(*args)
        got = ops.selective_scan(*args)
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        C.require(rel <= C.SCAN_REL, f"scan {name}: {rel}")
        row = {"phase": "probe.selective_scan", "case": name,
               "shape": list(args[0].shape) + [n], "max_rel": rel,
               "bound_ms": C._scan_bound(b, args[0].shape[1], d, n,
                                         h0=args[6] is not None)[0],
               "kernel_ms": C.device_ms(lambda: ops.selective_scan(*args))}
        if parent is not None:
            fn = parent["selective_scan"]
            y, hl = torch.empty_like(args[0]), torch.empty_like(h0)
            ptrs = [t.data_ptr() if t is not None else None for t in args]

            def old():
                rc = fn(*ptrs, y.data_ptr(), hl.data_ptr(), b,
                        args[0].shape[1], d, n,
                        torch.cuda.current_stream().cuda_stream)
                C.require(rc == 0, f"parent selective_scan: CUDA error {rc}")
                return y
            row.update(_in_turns(old, lambda: ops.selective_scan(*args)))
        C.log(row)


def _scan_bwd_args(gen, b, s, d, n, with_dhl):
    """Seeded inputs of the scan's backward, drawn as ``chip_smoke.py``
    draws them: ((x, dt, B, C, A, D, h0), dy, dh_last or None)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, bb, cc = randn(b, s, d), randn(b, s, n, scale=0.5), \
        randn(b, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    a = torch.exp(randn(d, n, scale=0.3))
    dsk, h0 = randn(d), randn(b, d, n)
    dy, dhl = randn(b, s, d), randn(b, d, n)
    return (x, dt, bb, cc, a, dsk, h0), dy, dhl if with_dhl else None


def _scan_bwd_launch(fn, ins, hc, dy, dhl):
    """One call of a selective_scan_bwd C entry point, its outputs
    allocated and zeroed as ``ops.selective_scan_bwd`` does."""
    x, dt, bb, cc, a, dsk = ins[:6]
    bsz, s, d = x.shape
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.zeros_like(bb), torch.zeros_like(cc)
    da, dd = torch.zeros_like(a), torch.zeros_like(dsk)
    dh0 = torch.empty((bsz, d, a.shape[1]), device=x.device)
    rc = fn(*[t.data_ptr() for t in (x, dt, bb, cc, a, dsk, hc, dy)],
            None if dhl is None else dhl.data_ptr(),
            *[t.data_ptr() for t in (dx, ddt, db, dc, da, dd, dh0)],
            bsz, s, d, a.shape[1], torch.cuda.current_stream().cuda_stream)
    C.require(rc == 0, f"selective_scan_bwd: CUDA error {rc}")
    return dx, ddt, db, dc, da, dd, dh0


#: Ablations of selective_scan_bwd.cu, each a list of (text, replacement)
#: pairs; each text must occur in the source exactly once. ``warps8``: the
#: layout of 8-warp blocks, one an SM; ``no_compute``: no warp recomputes
#: or walks (staging, write-out, dB/dC flush and barriers remain);
#: ``no_walk``: the recompute and the carry scan, no backward walk;
#: ``loads_only``: ``no_compute`` without the dx/ddt stores and the dB/dC
#: atomics (the inputs staged, the barriers).
_NO_COMPUTE = (("      if (d < Di) {\n", "      if (d < Di && S < 0) {\n"),)
SCAN_BWD_VARIANTS = {
    "warps8": (("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
               ("constexpr int kBlocksPerSm = 2;",
                "constexpr int kBlocksPerSm = 1;")),
    "no_compute": _NO_COMPUTE,
    "no_walk": (("        // walk the chunk backwards with its true carry\n",
                 "        if (S < 0) {\n"),
                ("        // chunk sp·kC sends its carry left",
                 "        }\n        // chunk sp·kC sends its carry left")),
    "loads_only": _NO_COMPUTE + (
        ("if (dc < Di && t_base + tl < S) {",
         "if (dc < Di && t_base + tl < S && S < 0) {"),
        ("      if (t_base + tl < S) {",
         "      if (t_base + tl < S && S < 0) {")),
}


def _scan_bwd_variant(name: str):
    """Build this tree's selective_scan_bwd.cu patched as
    ``SCAN_BWD_VARIANTS[name]`` under ``build/variant/``; its entry point,
    or None (logged) if nvcc refused it."""
    from repro_torch import cuda_build
    src = (cuda_build.CSRC / "selective_scan_bwd.cu").read_text()
    for old, new in SCAN_BWD_VARIANTS[name]:
        C.require(src.count(old) == 1,
                  f"variant {name}: {old!r} not once in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "variant"
    out.mkdir(parents=True, exist_ok=True)
    source, lib = out / f"scan_bwd_{name}.cu", out / f"scan_bwd_{name}.so"
    source.write_text(src)
    try:
        secs = _nvcc(source, lib)
    except subprocess.CalledProcessError as e:
        C.log({"phase": "probe.selective_scan_bwd.variant", "variant": name,
               "failed": (e.stdout + e.stderr)[-4000:]})
        return None
    symbol, argtypes = cuda_build.SIGNATURES["selective_scan_bwd"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    C.log({"phase": "probe.selective_scan_bwd.variant", "variant": name,
           "build_s": secs,
           "ptxas": [ln.strip() for ln in lib.with_suffix(".log")
                     .read_text().splitlines()
                     if "registers" in ln or "spill" in ln]})
    return fn


def probe_scan_bwd(gen, parent, variants) -> None:
    """``variants``: label -> another build's entry point, held and timed
    at the training shape only (a build may refuse some N)."""
    from repro_torch import cuda_build
    from repro_torch.kernels import ops, ref
    names = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")
    new = cuda_build.entry("selective_scan_bwd")
    bad = []
    for shape, with_dhl in ((C.TRAIN_SCAN_SHAPE, True),) \
            + C.SCAN_BWD_RAGGED:
        ins, dy, dhl = _scan_bwd_args(gen, *shape, with_dhl)
        hc = ref.selective_scan_fwd_ref(*ins, ops.SCAN_CHUNK)[2]
        want = dict(zip(names, ref.selective_scan_bwd_ref(
            *ins[:6], hc, dy, dhl, ops.SCAN_CHUNK)))
        row = {"phase": "probe.selective_scan_bwd", "shape": list(shape),
               "dh_last": with_dhl}
        train = tuple(shape) == C.TRAIN_SCAN_SHAPE
        others = dict(variants) if train else {}
        if parent is not None:
            others["parent"] = parent["selective_scan_bwd"]
        for label, fn in {"new": new, **others}.items():
            got = _scan_bwd_launch(fn, ins, hc, dy, dhl)
            torch.cuda.synchronize()
            row[f"{label}_rel"] = C._rel_errs(dict(zip(names, got)), want)
        if not all(e <= C.SCAN_GRAD_REL for e in row["new_rel"].values()):
            bad.append(f"selective_scan_bwd at {shape}: {row['new_rel']}")
        if train:
            row["bound_ms"] = C._scan_bwd_bound(*shape)[0]
            row["wrapper_ms"] = C.device_ms(lambda: ops.selective_scan_bwd(
                *ins[:6], hc, dy, dhl))
            for label, fn in others.items():
                row[f"{label}_turns"] = _in_turns(
                    lambda f=fn: _scan_bwd_launch(f, ins, hc, dy, dhl),
                    lambda: _scan_bwd_launch(new, ins, hc, dy, dhl))
        C.log(row)
    C.require(not bad, "; ".join(bad))


def probe_masked_update(g, owner, gen, parent) -> None:
    from repro_torch import engine as E
    from repro_torch.engine import kernels as Kn
    from repro_torch.engine.plan import shard_plan
    plan = E.compile_plan(g, owner, C.K)
    for where, p in (("plan", plan),
                     ("block", shard_plan(plan, 0, C.DIST_BLOCK_WORLD))):
        for f in (1, 3, 8, C.SERVE_LANES):
            shape = (p.k, p.v_max) + ((f,) if f > 1 else ())
            state = torch.rand(shape, generator=gen, device="cuda") * 30
            state = torch.where(torch.rand(shape, generator=gen,
                                           device="cuda") < 0.2,
                                float("inf"), state)
            glob = torch.rand((p.n_vertices,) + shape[2:], generator=gen,
                              device="cuda") * 30
            args = (state, glob, p.local2global, p.vmask, p.replicated)
            for combine in ("min", "add"):
                C.require(torch.equal(Kn.masked_update(*args, combine),
                                      Kn.masked_update_ref(*args, combine)),
                          f"masked_update {where} F={f} {combine}")
            row = {"phase": "probe.masked_update", "where": where,
                   "shape": list(shape), "bound_ms": C._mu_bound(p, f)[0],
                   "kernel_ms": C.device_ms(
                       lambda: Kn.masked_update(*args, "min"))}
            if parent is not None:
                old_fn = parent["masked_update"]

                def old(a=args, pp=p, width=f):
                    out = torch.empty_like(a[0])
                    rc = old_fn(*[t.data_ptr() for t in (*a, out)],
                                pp.k * pp.v_max, width, pp.n_vertices,
                                Kn._IDENTITY["min"],
                                torch.cuda.current_stream().cuda_stream)
                    C.require(rc == 0, f"parent masked_update: {rc}")
                    return out
                C.require(torch.equal(old(), Kn.masked_update(*args,
                                                              "min")),
                          f"parent masked_update {where} F={f}")
                row.update(_in_turns(old, lambda a=args: Kn.masked_update(
                    *a, "min")))
            C.log(row)


def _chain_parts(Kn, plan, values, combine, update) -> dict:
    """The device operations of the parent's exchange chain
    (``Kn.exchange_ref`` with ``update``), each alone on the inputs it gets
    in the chain: name -> call. ``expand`` is a view (no kernel)."""
    ident = Kn._IDENTITY[combine]
    tail = tuple(values.shape[2:])
    mask = plan.vmask & plan.replicated
    mask = mask[:, :, None] if tail else mask
    send = torch.where(mask, values, ident).reshape((-1,) + tail)
    idx = plan.index64("local2global").reshape(-1)
    glob = torch.full((plan.n_vertices,) + tail, ident, device=values.device)

    def expand():
        return idx.reshape(-1, 1).expand(-1, *tail) if tail else idx
    wide = expand()
    return {
        "and": lambda: plan.vmask & plan.replicated,
        "where": lambda: torch.where(mask, values, ident),
        "full": lambda: torch.full((plan.n_vertices,) + tail, ident,
                                   device=values.device),
        "expand": expand,
        "scatter_reduce": lambda: glob.scatter_reduce_(
            0, wide, send, Kn._SCATTER[combine]),
        "masked_update": lambda: update(values, glob, plan.local2global,
                                        plan.vmask, plan.replicated,
                                        combine)}


def _exchange_launch(Kn, plan, lay, values, combine, groups=True,
                     slots=True, fn=None):
    """One ``replica_exchange_f32`` launch over ``lay`` as the wrapper makes
    it (of ``fn``, another build of it, if given); ``groups=False`` /
    ``slots=False`` leave out the group pass or the slot pass (timing
    only: the output is then not whole)."""
    from repro_torch import cuda_build
    out = torch.empty_like(values)
    f = 1 if values.ndim == 2 else int(values.shape[2])
    rc = (fn or cuda_build.entry("replica_exchange"))(
        *[t.data_ptr() for t in (values, plan.vmask, plan.replicated,
                                 lay.ptr, lay.slots, out)],
        lay.n_groups if groups else 0,
        plan.k * plan.v_max if slots else 0, f, Kn._OP_CODE[combine], 1,
        torch.cuda.current_stream().cuda_stream)
    C.require(rc == 0, f"replica_exchange: CUDA error {rc}")
    return out


def _ordered_layout(Kn, plan, lay, order: str):
    """``lay`` with its groups listed in another order (each group's slots
    and fold unchanged, so the result is the same bits): by falling size,
    then ``first_slot`` (the group's lowest flat slot) or ``signature``
    (the set of partitions it spans, then vertex)."""
    ptr, slots = lay.ptr.long(), lay.slots.long()
    size = torch.diff(ptr)
    arange = torch.arange(lay.n_groups, device=ptr.device)
    group = torch.repeat_interleave(arange, size, output_size=lay.n_slots)
    if order == "first_slot":
        key = slots[ptr[:-1]]
    else:
        sig = torch.zeros(lay.n_groups, dtype=torch.long, device=ptr.device)
        sig.index_add_(0, group, 1 << (slots // plan.v_max))
        vertex = plan.local2global.reshape(-1)[slots[ptr[:-1]]].long()
        key = sig * plan.n_vertices + vertex
    perm = torch.argsort((lay.largest - size) * (int(key.max()) + 1) + key)
    new_size = size[perm]
    new_ptr = Kn._ptr(new_size)
    new_group = torch.repeat_interleave(arange, new_size,
                                        output_size=lay.n_slots)
    src = ptr[perm][new_group] + torch.arange(lay.n_slots,
                                              device=ptr.device) \
        - new_ptr[new_group]
    return dataclasses.replace(lay, ptr=new_ptr.to(torch.int32),
                               slots=slots[src].to(torch.int32))


@contextlib.contextmanager
def _chain_exchange(Kn, update):
    """The engine's exchange replaced by the parent's chain
    (``Kn.exchange_ref`` closed by ``update``) inside the block."""
    saved = Kn.exchange
    Kn.exchange = lambda plan, values, combine="min": Kn.exchange_ref(
        plan, values, combine, update=update)
    try:
        yield
    finally:
        Kn.exchange = saved


def _end_to_end(g, plan, update) -> dict:
    """Warm wall s (median of E2E_RUNS) of the main path's programs and the
    two GNN layers, with the parent's chain and with the kernel, in turns:
    parent, new, new, parent."""
    import numpy as np
    from repro_torch import engine as E
    from repro_torch.engine import kernels as Kn
    rng = np.random.default_rng(C.SEED)
    n, deg = g.n_vertices, g.degrees()
    x = rng.normal(size=(n, E.GCN_F_IN)).astype(np.float32)
    weight = rng.normal(size=(E.GCN_F_IN, E.GCN_F_OUT)).astype(np.float32)
    entity = rng.normal(size=(n, E.KGE_F)).astype(np.float32)
    relation = rng.normal(size=(g.e_pad, E.KGE_F)).astype(np.float32)
    eng = E.Engine(plan)
    runs = {"sssp": lambda: E.engine_sssp(eng, 0),
            "wcc": lambda: E.engine_wcc(eng),
            "pagerank": lambda: E.engine_pagerank(eng, deg, iters=30),
            "gcn_layer": lambda: E.engine_gcn_layer(eng, deg, x, weight),
            "kge_score": lambda: E.engine_kge_score(eng, entity, relation)}

    def warm(run):
        run()
        return float(np.median([C.wall(run)[1] for _ in range(E2E_RUNS)]))
    out = {}
    for name, run in runs.items():
        with _chain_exchange(Kn, update):
            p1 = warm(run)
            want = run()
        n1, n2 = warm(run), warm(run)
        got = run()
        with _chain_exchange(Kn, update):
            p2 = warm(run)
        C.require(got.row() == want.row(), f"{name}: counters differ")
        out[name] = {"parent_s": [p1, p2], "new_s": [n1, n2],
                     "max_abs_diff": float((got.state - want.state).abs()
                                           .nan_to_num().max())}
    return out


def probe_exchange(g, owner, gen, parent, twin) -> None:
    """At ``chip_smoke.EXCHANGE_CASES``: the parent's exchange chain in
    parts (device ms under a CUDA graph, eager ms with the host's launch
    cost) and whole; the kernel, its group and slot passes alone, and
    writing its output (``fill_``); the parent chain and the kernel in
    turns; with ``twin`` (another build's entry point), that build against
    this one in turns; an empty kernel's launch; then the programs end to
    end in turns (``_end_to_end``)."""
    from repro_torch import engine as E
    from repro_torch.engine import kernels as Kn
    plan = E.compile_plan(g, owner, C.K)
    lay = Kn.exchange_layout(plan)
    orders = {name: _ordered_layout(Kn, plan, lay, name)
              for name in EX_ORDERS}
    empty = _empty_kernel()
    C.log({"phase": "probe.exchange.layout", **lay.stats(),
           "build_s": C.wall(lambda: Kn.build_exchange_layout(plan))[1],
           "empty_kernel_ms": C.device_ms(lambda: C.require(
               empty(torch.cuda.current_stream().cuda_stream) == 0,
               "empty kernel"))})
    update = Kn.masked_update
    if parent is not None:
        old_fn = parent["masked_update"]

        def update(state, glob, l2g, vmask, rep, combine):
            out = torch.empty_like(state)
            f = 1 if state.ndim == 2 else int(state.shape[2])
            rc = old_fn(*[t.data_ptr() for t in (state, glob, l2g, vmask,
                                                 rep, out)],
                        plan.k * plan.v_max, f, plan.n_vertices,
                        Kn._IDENTITY[combine],
                        torch.cuda.current_stream().cuda_stream)
            C.require(rc == 0, f"parent masked_update: CUDA error {rc}")
            return out
    for label, f, combine in C.EXCHANGE_CASES:
        values = C._exchange_values(plan, gen, f, combine)
        want = Kn.exchange_ref(plan, values, combine)

        def chain():
            return Kn.exchange_ref(plan, values, combine, update=update)

        def new():
            return Kn.exchange(plan, values, combine)
        for what, got in (("chain", chain()), ("kernel", new())):
            if combine == "add":
                C.require(C._max_abs(got, want) <= C.EXCHANGE_ADD_ATOL,
                          f"exchange {what} {label} off the plain version")
            else:
                C.require(torch.equal(got, want), f"exchange {what} {label}")
        C.require(torch.equal(new(), Kn.exchange_layout_ref(
            plan, values, combine)), f"exchange {label} off its layout walk")
        parts = _chain_parts(Kn, plan, values, combine, update)
        out = torch.empty_like(values)
        row = {"phase": "probe.exchange", "case": label,
               "shape": list(values.shape),
               "bound_ms": C._exchange_bound(plan, f)[0],
               "parts_ms": {name: C.device_ms(fn) for name, fn in
                            parts.items() if name != "expand"},
               "parts_eager_ms": {name: C.eager_ms(fn)
                                  for name, fn in parts.items()},
               "chain_ms": C.device_ms(chain),
               "chain_eager_ms": C.eager_ms(chain),
               "kernel_ms": C.device_ms(new), "kernel_eager_ms":
                   C.eager_ms(new),
               "groups_only_ms": C.device_ms(lambda: _exchange_launch(
                   Kn, plan, lay, values, combine, slots=False)),
               "slots_only_ms": C.device_ms(lambda: _exchange_launch(
                   Kn, plan, lay, values, combine, groups=False)),
               "fill_ms": C.device_ms(lambda: out.fill_(0.0)),
               "turns": _in_turns(chain, new)}
        for name, other in orders.items():
            C.require(torch.equal(_exchange_launch(
                Kn, plan, other, values, combine), want if combine != "add"
                else new()), f"exchange {label}: order {name} differs")
            row[f"order_{name}_ms"] = C.device_ms(
                lambda: _exchange_launch(Kn, plan, other, values, combine))
        if twin is not None:
            def other():
                return _exchange_launch(Kn, plan, lay, values, combine,
                                        fn=twin)
            C.require(torch.equal(other(), new()), f"twin {label} differs")
            row["twin_turns"] = _in_turns(other, new)
        C.log(row)
        del values, want, parts, out
    C.log({"phase": "probe.exchange.end_to_end",
           **_end_to_end(g, plan, update)})


#: Other orders of the exchange layout's groups timed (``_ordered_layout``).
EX_ORDERS = ("first_slot", "signature")
#: Warm runs a program's end-to-end time is the median of.
E2E_RUNS = 5

PROBES = ("segment_reduce", "gspmm", "selective_scan", "minplus_sweep",
          "exchange", "selective_scan_bwd", "masked_update")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--twin", type=Path, default=None,
                    help="a checkout whose gspmm.cu or replica_exchange.cu "
                         "has this tree's C interface, timed in turns "
                         "against this tree's")
    ap.add_argument("--scan-bwd-variant", default="",
                    help="comma-separated subset of "
                         f"{tuple(SCAN_BWD_VARIANTS)}: this tree's "
                         "selective_scan_bwd.cu patched so, timed in turns")
    ap.add_argument("--only", default=",".join(PROBES),
                    help=f"comma-separated subset of {PROBES}")
    args = ap.parse_args()
    only = args.only.split(",")
    C.require(set(only) <= set(PROBES), f"--only takes {PROBES}")
    card = C.phase_device()
    print(card, flush=True)
    parent = None if args.parent is None else _parent_entries(
        args.parent, [PARENT_OF.get(name, name) for name in only
                      if PARENT_OF.get(name, name) in PARENT])
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    if "selective_scan" in only:
        probe_scan(gen, parent)
    if "selective_scan_bwd" in only:
        variants = {}
        for name in filter(None, args.scan_bwd_variant.split(",")):
            fn = _scan_bwd_variant(name)
            if fn is not None:
                variants[name] = fn
        probe_scan_bwd(gen, parent, variants)
    if {"segment_reduce", "gspmm", "minplus_sweep", "exchange",
            "masked_update"} & set(only):
        from repro_torch.core import dfep, graph
        g = graph.load_dataset("dblp", scale=C.DBLP_SCALE, seed=C.SEED)
        owner, _ = dfep.partition(g, k=C.K, seed=C.SEED, max_rounds=4000,
                                  stall_rounds=64)
        if "segment_reduce" in only:
            probe_segment(g, owner, gen, parent)
        if "gspmm" in only:
            twin = None
            if args.twin is not None:
                twin, secs = _twin_entry(args.twin, "gspmm")
                C.log({"phase": "probe.gspmm.twin", "build_s": secs})
            probe_gspmm(g, owner, gen, parent, twin)
        if "minplus_sweep" in only:
            probe_minplus(g, owner, gen, parent)
        if "masked_update" in only:
            probe_masked_update(g, owner, gen, parent)
        if "exchange" in only:
            twin = None
            if args.twin is not None:
                twin, secs = _twin_entry(args.twin, "replica_exchange")
                C.log({"phase": "probe.exchange.twin", "build_s": secs})
            probe_exchange(g, owner, gen, parent, twin)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
