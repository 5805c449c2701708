"""Time the design choices of minplus_sweep and selective_scan on one GPU,
and, with ``--parent``, the kernels they replaced, in the same process.

    python3 tools/probe_kernels.py [--parent DIR]

minplus_sweep: on dblp 1.0 partitioned by DFEP (K = 16, 4000 rounds, as
``chip_smoke.py``'s main phase), ETSCH's flat [K·V] state (~20% +inf,
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

``--parent DIR`` names a checkout of the commit before the redesign: its
``csrc/minplus_sweep.cu`` (a copy and an atomic scatter over
[K·S·e_max] index arrays) and ``csrc/selective_scan.cu`` (a thread per
state element) are built with nvcc into ``build/parent/`` and called
through their own C entry points, timed in the order parent, new, new,
parent. Device times are CUDA-graph replays (``chip_smoke.device_ms``).
One JSON object per line; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
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
#: The replaced kernels' C entry points: (symbol, argtypes).
PARENT = {
    "minplus_sweep": ("minplus_sweep_f32",
                      [_P] * 5 + [_L, _L, ctypes.c_float, _P]),
    "selective_scan": ("selective_scan_f32", [_P] * 9 + [_I] * 4 + [_P]),
}


def _parent_entries(parent: Path) -> dict:
    from repro_torch import cuda_build
    out_dir = ROOT / "build" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    fns = {}
    for name, (symbol, argtypes) in PARENT.items():
        lib = out_dir / f"{name}.so"
        subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                        str(parent / "src/repro_torch/csrc" / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _in_turns(parent_fn, new_fn) -> dict:
    """parent, new, new, parent: device ms of each."""
    p1, n1 = C.device_ms(parent_fn), C.device_ms(new_fn)
    n2, p2 = C.device_ms(new_fn), C.device_ms(parent_fn)
    return {"parent_ms": [p1, p2], "new_ms": [n1, n2]}


def probe_minplus(gen, parent) -> None:
    from repro_torch.core import dfep, etsch, graph
    from repro_torch.kernels import ops, ref
    g = graph.load_dataset("dblp", scale=C.DBLP_SCALE, seed=C.SEED)
    owner, _ = dfep.partition(g, k=C.K, seed=C.SEED, max_rounds=4000,
                              stall_rounds=64)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    card = C.phase_device()
    print(card, flush=True)
    parent = None if args.parent is None else _parent_entries(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    probe_scan(gen, parent)
    probe_minplus(gen, parent)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
