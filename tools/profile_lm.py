"""Profile Mamba serving (falcon-mamba-7b, full width and depth) on one GPU.

    python3 tools/profile_lm.py

Draws the model on the card from seed 0, as ``chip_smoke.py``'s ``lm``
phase does, and profiles one prefill of 4 prompts of 512 tokens and one
decode step after it under ``torch.profiler``, each after a warm-up call.
Prints the card's name and power limit, then per call: the host wall time
(``torch.cuda.synchronize`` on both ends, outside the profiler and under
it), the number of CUDA kernels, their summed device time, the device's
busy share of the unprofiled wall time, the device time of ``aten::copy_``
(the float32→bfloat16 weight casts, and the other copies), of ``aten::mm``
and of the ``selective_scan`` kernels (prefill's and decode's; their names
start with it) with their count, and the ops that take the most device time.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

BATCH, PROMPT = 4, 512


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profile(name: str, fn) -> None:
    fn()
    wall = min(_wall(fn) for _ in range(3))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = _wall(fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    scans = [e for e in kernels if "selective_scan" in e.name]
    ops = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()}
    print(json.dumps({
        "call": name, "wall_ms": 1e3 * wall,
        "wall_ms_under_profiler": 1e3 * wall_prof,
        "cuda_kernels": len(kernels), "device_ms": device_ms,
        "device_busy_share": device_ms / (1e3 * wall),
        "copy_ms": ops.get("aten::copy_", 0.0),
        "matmul_ms": ops.get("aten::mm", 0.0),
        "selective_scan_kernels": len(scans),
        "selective_scan_ms": sum(e.device_time for e in scans) / 1e3,
    }), flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import serve_step as SS

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("falcon-mamba-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    with torch.inference_mode():
        logits, caches = SS.prefill(cfg, params, prompts)
        tok = SS.greedy_token(logits[:, -1:], cfg.vocab)
        del logits
        _profile("prefill", lambda: SS.prefill(cfg, params, prompts))
        _profile("decode", lambda: SS.decode(cfg, params, tok, caches,
                                             PROMPT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
