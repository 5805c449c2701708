"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` for ``sm_90a`` (H100) into its own shared library under
``build/kernels/`` at the repository root, named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is reused.
Libraries are built at first use; :func:`build` builds several at once, one
``nvcc`` process per source, all started together. Nothing is compiled when
this module is imported, and a machine without ``nvcc`` raises when a kernel
is needed. :func:`on_card`, :func:`check` and :func:`stream` are the
dispatch and argument checks every kernel wrapper shares.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: Where the CUDA toolkit puts nvcc when it is not on PATH.
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each library's entry point: (function, argtypes).
SIGNATURES = {
    "segment_reduce": ("segment_reduce_f32",
                       [_P] * 9 + [_I] * 9 + [_P]),
    "masked_update": ("masked_update_f32",
                      [_P] * 6 + [ctypes.c_longlong, _I, _I, ctypes.c_float,
                                  _P]),
    "gspmm": ("gspmm_f32", [_P] * 13 + [_I] * 13 + [_P]),
    "replica_exchange": ("replica_exchange_f32", [_P] * 6 + [_I] * 5 + [_P]),
    "lane_cumsum": ("lane_cumsum", [_P] * 3 + [ctypes.c_longlong]
                    + [_I] * 3 + [_P]),
    "frontier_min": ("frontier_min", [_P] * 3 + [_I, ctypes.c_longlong, _I,
                                                 _I, _P]),
    "minplus_sweep": ("minplus_sweep_f32", [_P] * 7
                      + [_I] * 3 + [ctypes.c_longlong, _I, _I, _I, _I,
                                    ctypes.c_float, _I, _P]),
    "selective_scan": ("selective_scan_f32", [_P] * 10 + [_I] * 4 + [_P]),
    "selective_scan_bwd": ("selective_scan_bwd_f32",
                           [_P] * 16 + [_I] * 4 + [_P]),
}
#: Layout queries a library exports beside its entry point, so that the
#: kernel's source alone decides its tiles: symbol -> (library, argtypes),
#: each returning a long long (-1 for arguments the kernel refuses).
QUERIES = {
    "lane_cumsum_tile_rows": ("lane_cumsum", [_I, _I]),
    "lane_cumsum_scratch_words": ("lane_cumsum",
                                  [ctypes.c_longlong, _I, _I]),
    "selective_scan_lanes": ("selective_scan", [_I]),
    "selective_scan_chunk": ("selective_scan", []),
    "selective_scan_bwd_chunk": ("selective_scan_bwd", []),
}

_LOADED: dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (or a
    mix) raises — a kernel wrapper never silently changes device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one CPU or CUDA device, got "
                     f"{sorted({str(t.device) for t in tensors})}")


def check(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})")


def stream() -> int:
    """PyTorch's current CUDA stream, as the int the C entry points take."""
    return torch.cuda.current_stream().cuda_stream


def find_nvcc() -> str:
    """Path of ``nvcc`` (on PATH, or the toolkit's default place)."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` goes, keyed by a hash of
    the source and the flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, float]:
    """Compile the named libraries that are not built yet, one ``nvcc`` per
    source, all running at once. Returns seconds per library built (0.0 for
    one that was already there); raises with the compiler's output on
    failure. The compiler's messages (``-Xptxas=-v``: registers, spills)
    are kept beside each library as ``<library>.log``."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {n: 0.0 for n in names}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: secs.get(n, 0.0) for n in names}


def build_log(name: str) -> str:
    """The compiler's messages from building ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def _load(library: str, symbol: str, argtypes, restype):
    """``symbol`` of library ``library``, built and loaded on first use."""
    with _LOCK:
        fn = _LOADED.get(symbol)
        if fn is None:
            build((library,))
            fn = getattr(ctypes.CDLL(str(library_path(library))), symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            _LOADED[symbol] = fn
        return fn


def entry(name: str):
    """The C entry point of library ``name``, with its argtypes and an int
    restype (the CUDA error code)."""
    symbol, argtypes = SIGNATURES[name]
    return _load(name, symbol, argtypes, ctypes.c_int)


def query(symbol: str):
    """A layout query of :data:`QUERIES`, returning a long long."""
    library, argtypes = QUERIES[symbol]
    return _load(library, symbol, argtypes, ctypes.c_longlong)
