"""Probe how far llava-next-34b's decode may differ from its prefill on one
GPU, at full width, in bfloat16 and in float32.

    python3 tools/probe_vlm_decode.py

Draws llava-next-34b cut to 20 layers from seed 0 on the card, as
``chip_smoke.py``'s ``lm.vlm`` phase does, with the ``SyntheticPipeline``
batch of that phase (2 prompts of 1,215 tokens after 2,880 image
embeddings). For the model's first 1, 5, 10 and 20 layers it measures,
relative to the largest logit: decode for token s (written and attending
at 2,880 + s) against the last logits of a prefill of s + 1
(``decode_vs_prefill``), and the two prefills' logits at their last shared
position (``prefill_vs_prefill``: the model's own bfloat16 noise, with
the s and s + 1 prefills' keys split into 3 and 4 flash-scan blocks). At
20 layers it measures both again with ``layers.COMPUTE_DTYPE`` set to
float32, and the bfloat16 logits against the float32 ones. Prints the
card's name and power limit, then one JSON line a depth and one for
float32.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import serve_step as SS  # noqa: E402

LAYERS, BATCH, PROMPT = 20, 2, 1215


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


@torch.inference_mode()
def _run(cfg, params, prompts, img, tok=None) -> dict:
    """Decode for token s and the last logits of both prefills, float32;
    ``tok`` (the token s) is the prefill's greedy choice unless given."""
    n_img, s = img.shape[1], prompts.shape[1]
    lg, _, caches = lm.forward_lm(cfg, params, prompts, img_embeds=img,
                                  collect_cache=True)
    if tok is None:
        tok = SS.greedy_token(lg[:, -1:], cfg.vocab)
    last = lg[:, -1].float()
    del lg
    grown = SS.grow_caches(cfg, caches, prompts.shape[0], n_img + s + 1)
    del caches
    dec = SS.decode(cfg, params, tok, grown, n_img + s)[0][:, 0].float()
    del grown
    full, _, _ = lm.forward_lm(cfg, params, torch.cat([prompts, tok], 1),
                               img_embeds=img)
    out = {"dec": dec, "full": full[:, -1].float(),
           "prev": full[:, -2].float(), "last": last, "tok": tok}
    del full
    torch.cuda.empty_cache()
    return out


def _first_layers(params: dict, k: int) -> dict:
    def cut(tree):
        if isinstance(tree, dict):
            return {n: cut(v) for n, v in tree.items()}
        return tree[:k]
    return {**params, "blocks": cut(params["blocks"])}


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, "cuda")
    data = SyntheticPipeline(cfg, DataConfig(BATCH, PROMPT, 0),
                             "cuda").batch_at(0)
    prompts, img = data["tokens"], data["img_embeds"]
    bf16 = _run(cfg, params, prompts, img)
    for k in (1, 5, 10, LAYERS):
        r = bf16 if k == LAYERS else _run(
            dataclasses.replace(cfg, n_layers=k), _first_layers(params, k),
            prompts, img, bf16["tok"])
        print(json.dumps({"layers": k, "compute": "bfloat16",
                          "decode_vs_prefill": _rel(r["dec"], r["full"]),
                          "prefill_vs_prefill": _rel(r["last"], r["prev"]),
                          "max_abs_logit": float(r["full"].abs().max())}),
              flush=True)
    real = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        f32 = _run(cfg, params, prompts, img, bf16["tok"])
    finally:
        L.COMPUTE_DTYPE = real
    print(json.dumps({
        "layers": LAYERS, "compute": "float32",
        "decode_vs_prefill": _rel(f32["dec"], f32["full"]),
        "prefill_vs_prefill": _rel(f32["last"], f32["prev"]),
        "bf16_prefill_vs_f32_prefill": _rel(bf16["full"], f32["full"]),
        "bf16_decode_vs_f32_prefill": _rel(bf16["dec"], f32["full"]),
        "max_abs_logit": float(f32["full"].abs().max())}), flush=True)


if __name__ == "__main__":
    main()
