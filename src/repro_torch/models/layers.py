"""Building blocks of the port's models (the counterpart of
``repro/models/layers.py``): RMSNorm, RoPE, GQA attention with the flash
scan and decode attention, cross-attention (in prefill over the encoder's
output, in decode over its precomputed k/v), MLA (DeepSeek-V2's latent
attention, its decode absorbed), the SwiGLU MLP and the capacity-bounded
MoE.

Parameters are stored float32 and cast to bfloat16 at each use; compute
runs in bfloat16 with float32 where the reference computes in float32
(the norm, RoPE, attention's softmax and products, the router, the MoE
combine). Heads and experts are padded to the active mesh's tensor
parallelism (``sharding.env.get_env().tp_size()``, 1 with no mesh), as the
reference pads them at init; the ``*_specs`` functions give each
parameter's logical partition spec, the reference's.

On a live mesh (``sharding.env``: one rank a mesh device) each rank holds
its shard of every parameter, the fsdp dimension already gathered by the
caller (``models/lm.py``), and each block runs as a tensor-parallel region
over the tp group, Megatron-style: the input enters through
``collectives.copy_to_tp`` and the partial output leaves through
``collectives.reduce_from_tp``. Attention runs this rank's q heads
against the kv heads they read (its kv cache holds only those), MLA its
heads over a latent every rank computes, the MLP its d_ff columns, the MoE
its experts (the reference's ``shard_map`` worker: capacity from the
dp-local tokens, positions from the sort over all experts, a float32
all-reduce of the combine). Leaves a region uses whole on every tp rank
(kv projections, q/k norms, MLA's down-projections, the router) get a
partial gradient on each, which the train step sums over tp.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

from ..core import collectives as C
from ..sharding.env import get_env, place
from .flash_vjp import flash_fa2
from .perf import get_perf

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def _init(generator: torch.Generator, shape, scale: float | None = None,
          device=None) -> torch.Tensor:
    """Normal(0, 1) · ``scale`` (0.02 when None), float32, drawn from
    ``generator`` on ``device``."""
    scale = 0.02 if scale is None else scale
    out = torch.randn(shape, generator=generator, dtype=PARAM_DTYPE,
                      device=device)
    return out.mul_(scale)


def pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tp_region():
    """(group, index, size) of the live env's tp axis, or None off a live
    mesh: whether a block runs as a tensor-parallel region."""
    env = get_env()
    if not env.is_live or env.tp is None:
        return None
    return env.group(env.tp), env.tp_index(), env.tp_size()


def local_kv_heads(h_loc: int, kv: int, tp: int, index: int) -> list[int]:
    """The kv heads this tp rank's ``h_loc`` q heads read, in the order its
    grouped attention takes them: q head j of the ``h_loc · tp`` reads kv
    head ``j // (h_loc · tp / kv)``. When every listed kv head serves an
    equal, contiguous run of the local q heads the list has one entry a
    kv head (grouped attention over the local kv heads); otherwise one
    entry a q head (each q head its own kv head)."""
    g = h_loc * tp // kv
    want = [(index * h_loc + j) // g for j in range(h_loc)]
    uniq = list(dict.fromkeys(want))
    run = h_loc // len(uniq)
    if h_loc % len(uniq) == 0 and all(want[j] == uniq[j // run]
                                      for j in range(h_loc)):
        return uniq
    return want


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · (1 / (1 + exp(-x)))`` in ``x``'s dtype, each step rounded to
    it, as ``jax.nn.silu`` computes it. ``F.silu`` computes in float32 and
    rounds once, which often differs from it by one bfloat16 ulp."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def pad_heads(h: int, kv: int, tp: int = 1) -> tuple[int, int]:
    """Pad (q-heads, kv-heads) so q-heads shard over ``tp`` and group
    evenly. At tp = 1 it keeps (h, kv) unless kv ≥ h, which gives
    (h, h)."""
    h_pad = pad_to(h, tp)
    if kv >= h_pad:
        return h_pad, h_pad
    kv_pad = kv
    while h_pad % kv_pad != 0:
        kv_pad += 1
    return h_pad, kv_pad


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x [..., S, dh] (dh even), positions [S] or broadcastable. The split
    halves rotate together (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [dh/2]
    ang = positions[..., :, None].float() * freqs             # [S, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shape of each attention parameter (``wq`` [d, h, dh], ``wo``
    [h, dh, d]; ``bq/bk/bv`` with ``qkv_bias``, ``q_norm/k_norm`` with
    ``qk_norm``), heads padded to the active tp."""
    h, kv = pad_heads(cfg.n_heads, cfg.n_kv, get_env().tp_size())
    dh, d = cfg.head_dim, cfg.d_model
    out = {"wq": (d, h, dh), "wk": (d, kv, dh), "wv": (d, kv, dh),
           "wo": (h, dh, d)}
    if cfg.qkv_bias:
        out.update(bq=(h, dh), bk=(kv, dh), bv=(kv, dh))
    if cfg.qk_norm:
        out.update(q_norm=(dh,), k_norm=(dh,))
    return out


def attention_specs(cfg) -> dict[str, tuple]:
    """Logical partition spec of each attention parameter: q heads and
    ``wo``'s heads over tp, kv heads replicated across it, the model
    dimension over fsdp."""
    out: dict[str, tuple] = {"wq": ("fsdp", "tp", None),
                             "wk": ("fsdp", None, None),
                             "wv": ("fsdp", None, None),
                             "wo": ("tp", None, "fsdp")}
    if cfg.qkv_bias:
        out.update(bq=("tp", None), bk=(None, None), bv=(None, None))
    if cfg.qk_norm:
        out.update(q_norm=(None,), k_norm=(None,))
    return out


def _stacked(generator, shapes: dict, repeats: int, device, scales: dict,
             specs: dict) -> dict[str, torch.Tensor]:
    """Parameters stacked [R, ...] by name: normal · ``scales[name]``
    (0.02 when absent) for matrices, zeros for biases (``b*``), ones for
    norms (``*norm``); each drawn whole and, on a live mesh, cut to this
    rank's shard by its spec (``specs[name]``) before the next is drawn."""
    out = {}
    for name, shape in shapes.items():
        shape = (repeats,) + shape
        if name.endswith("norm"):
            t = torch.ones(shape, dtype=PARAM_DTYPE, device=device)
        elif name in ("bq", "bk", "bv"):
            t = torch.zeros(shape, dtype=PARAM_DTYPE, device=device)
        else:
            t = _init(generator, shape, scales.get(name), device)
        out[name] = place(t, (None,) + specs[name])
    return out


def _out_scale(cfg) -> float:
    return 0.02 / math.sqrt(2 * cfg.n_layers)


def init_attention(cfg, generator: torch.Generator, repeats: int,
                   device=None) -> dict[str, torch.Tensor]:
    """``repeats`` attention layers' parameters, each stacked [R, ...], with
    the reference's distributions: normal·0.02, ``wo`` ·0.02/√(2·n_layers),
    zero biases, unit norms."""
    return _stacked(generator, attention_shapes(cfg), repeats, device,
                    {"wo": _out_scale(cfg)}, attention_specs(cfg))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset=0, block: int = 1024
                    ) -> torch.Tensor:
    """Online-softmax attention in float32. q [B, H, Sq, dh]; k/v
    [B, KV, Sk, dh]; returns [B, H, Sq, dv] in q's dtype. Scans KV blocks
    (``n_blk = max(Sk // block, 1)`` of ``Sk // n_blk`` keys) carrying the
    running (max, sum, acc), in the reference's order, so no [Sq, Sk]
    score matrix is materialised.

    Under the thread's ``perf.get_perf()``: ``flash_custom_vjp`` with
    ``q_offset`` 0 goes to ``flash_vjp.flash_fa2`` with ``block`` if it
    splits Sk, else one block of Sk keys (the reference's rule);
    ``additive_mask`` adds a -inf causal bias instead of selecting;
    ``pv_bf16`` rounds the probabilities and values to bfloat16 for the
    PV product, whose sums stay float32."""
    perf = get_perf()
    if perf.flash_custom_vjp and isinstance(q_offset, int) \
            and q_offset == 0:
        sk = k.shape[2]
        return flash_fa2(q, k, v, causal, block if sk % block == 0 else sk)

    b, hq, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // kvh
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qf = (q.float() * scale).reshape(b, kvh, g, sq, dh)

    n_blk = max(sk // block, 1)
    block = sk // n_blk
    kb = k.float().reshape(b, kvh, n_blk, block, dh)
    vb = v.float().reshape(b, kvh, n_blk, block, dv)
    q_pos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, kvh, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, kvh, g, sq), device=dev)
    acc = torch.zeros((b, kvh, g, sq, dv), device=dev)
    for i in range(n_blk):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb[:, :, i])
        if causal:
            k_pos = i * block + torch.arange(block, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]              # [Sq, blk]
            if perf.additive_mask:
                s = s + torch.where(mask, torch.zeros((), device=dev),
                                    float("-inf"))
            else:
                s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        vblk = vb[:, :, i]
        if perf.pv_bf16:   # bf16 operands; their products and sums float32
            p, vblk = (t.to(COMPUTE_DTYPE).float() for t in (p, vblk))
        pv = torch.einsum("bkgqc,bkcd->bkgqd", p, vblk)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """Single-token attention against a cache. q [B, H, dh]; k_cache /
    v_cache [B, S, KV, dh]; cache positions at or past ``length`` are
    masked to -inf before a float32 softmax. Returns [B, H, dh] in q's
    dtype."""
    b, hq, dh = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = hq // kvh
    scale = 1.0 / math.sqrt(dh)
    qf = (q.float() * scale).reshape(b, kvh, g, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    logits = torch.where(valid, logits, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / l.clamp(min=1e-30),
                       v_cache.float())
    return out.reshape(b, hq, dh).to(q.dtype)


def attention(cfg, p: dict, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, cache=None, cache_len=None,
              kv_input: torch.Tensor | None = None, use_rope: bool = True):
    """GQA attention, prefill or decode, self- or cross-attention.

    prefill: x [B, S, D] -> (out [B, S, D], (k, v) each [B, Sk, KV, dh]);
    decode:  x [B, 1, D] and ``cache`` (k, v) [B, S_max, KV, dh] -> (out,
    new caches with this step's k/v written at ``cache_len``; the caches
    passed in are left as they were);
    cross:   k and v from ``kv_input`` [B, Sk, D] (the encoder's output)
    instead of x. RoPE only under ``use_rope``, its key positions
    ``arange(Sk)`` when ``kv_input`` is given.

    On a live mesh ``p`` holds this rank's q heads, and k/v (and the
    caches) only the kv heads they read (``local_kv_heads``); the output
    is all-reduced over tp.
    """
    b, sq, d = x.shape
    tp = tp_region()
    xc = x.to(COMPUTE_DTYPE)
    kv_src = xc if kv_input is None else kv_input.to(COMPUTE_DTYPE)
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])
        kv_src = xc if kv_input is None else C.copy_to_tp(kv_src, tp[0])
    kvp = _kv_params(cfg, p, tp)
    q = torch.einsum("bsd,dhk->bhsk", xc, p["wq"].to(COMPUTE_DTYPE))
    k = torch.einsum("bsd,dhk->bhsk", kv_src, kvp["wk"].to(COMPUTE_DTYPE))
    v = torch.einsum("bsd,dhk->bhsk", kv_src, kvp["wv"].to(COMPUTE_DTYPE))
    if cfg.qkv_bias:
        q = q + p["bq"].to(COMPUTE_DTYPE)[None, :, None, :]
        k = k + kvp["bk"].to(COMPUTE_DTYPE)[None, :, None, :]
        v = v + kvp["bv"].to(COMPUTE_DTYPE)[None, :, None, :]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if use_rope:
        kv_positions = positions if kv_input is None else torch.arange(
            k.shape[2], device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)

    if cache is not None:
        # write this step's k/v at cache_len (clamped to fit, as
        # ``dynamic_update_slice`` clamps), into copies of the caches
        k_cache, v_cache = (c.clone() for c in cache)
        start = min(max(int(cache_len), 0), k_cache.shape[1] - sq)
        k_cache[:, start:start + sq] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[:, start:start + sq] = v.transpose(1, 2).to(v_cache.dtype)
        out = decode_attention(q[:, :, 0, :], k_cache, v_cache,
                               cache_len + 1)[:, :, None, :]  # [B,H,1,dh]
        new_cache = (k_cache, v_cache)
    else:
        out = flash_attention(q, k, v, causal=causal)
        new_cache = (k.transpose(1, 2), v.transpose(1, 2))

    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(COMPUTE_DTYPE))
    if tp is not None:
        y = C.reduce_from_tp(y, tp[0])
    return y.to(x.dtype), new_cache


def _kv_params(cfg, p: dict, tp) -> dict:
    """``wk``, ``wv`` (and ``bk``, ``bv``) of the kv heads this rank's q
    heads read: all of them off a live mesh."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    if tp is None:
        return {n: p[n] for n in names}
    kv = p["wk"].shape[-2]
    idx = local_kv_heads(p["wq"].shape[-2], kv, tp[2], tp[1])
    if idx == list(range(kv)):
        return {n: p[n] for n in names}
    sel = torch.tensor(idx, device=p["wk"].device)
    return {n: p[n].index_select(p[n].ndim - 2, sel) for n in names}


def attention_fixed_kv(cfg, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor) -> torch.Tensor:
    """Cross-attention against precomputed k/v (encdec decode): x
    [B, 1, D], k_cache / v_cache [B, S_enc, KV, dh]; the query projection
    (and its bias), decode attention over all S_enc positions, then
    ``wo``. No RoPE and no cache write. On a live mesh: this rank's q
    heads against the caches of the kv heads they read (as
    ``lm.cross_kvs_from_memory`` computes them), all-reduced over tp."""
    tp = tp_region()
    xc = x.to(COMPUTE_DTYPE)
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])
    q = torch.einsum("bsd,dhk->bhsk", xc, p["wq"].to(COMPUTE_DTYPE))
    if cfg.qkv_bias:
        q = q + p["bq"].to(COMPUTE_DTYPE)[None, :, None, :]
    out = decode_attention(q[:, :, 0, :], k_cache, v_cache,
                           k_cache.shape[1])
    y = torch.einsum("bhsk,hkd->bsd", out[:, :, None, :],
                     p["wo"].to(COMPUTE_DTYPE))
    if tp is not None:
        y = C.reduce_from_tp(y, tp[0])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shape of each MLA parameter: the KV compression ``w_dkv`` [d, L]
    and its ``kv_norm``, the decoupled RoPE key ``w_kr`` [d, dr], the
    up-projections ``w_uk`` [L, h, dn] and ``w_uv`` [L, h, dv], the
    queries ``w_uq`` [q_in, h, dn + dr] (from ``w_dq`` [d, q_lora] and
    ``q_norm`` where ``q_lora``) and ``wo`` [h, dv, d]; h padded to a
    multiple of the active tp."""
    m, d = cfg.mla, cfg.d_model
    h = pad_to(cfg.n_heads, get_env().tp_size())
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    out = {"w_dkv": (d, m.kv_lora), "w_kr": (d, dr),
           "w_uk": (m.kv_lora, h, dn), "w_uv": (m.kv_lora, h, dv),
           "w_uq": (m.q_lora or d, h, dn + dr), "wo": (h, dv, d),
           "kv_norm": (m.kv_lora,)}
    if m.q_lora:
        out.update(w_dq=(d, m.q_lora), q_norm=(m.q_lora,))
    return out


def mla_specs(cfg) -> dict[str, tuple]:
    """Logical partition spec of each MLA parameter (heads over tp)."""
    out: dict[str, tuple] = {"w_dkv": ("fsdp", None), "w_kr": ("fsdp", None),
                             "w_uk": (None, "tp", None),
                             "w_uv": (None, "tp", None),
                             "w_uq": ("fsdp", "tp", None),
                             "wo": ("tp", None, "fsdp"), "kv_norm": (None,)}
    if cfg.mla.q_lora:
        out.update(w_dq=("fsdp", None), q_norm=(None,))
    return out


def init_mla(cfg, generator: torch.Generator, repeats: int, device=None
             ) -> dict[str, torch.Tensor]:
    """``repeats`` MLA layers' parameters, each stacked [R, ...], with the
    reference's distributions: normal·0.02, ``wo`` ·0.02/√(2·n_layers),
    unit norms."""
    return _stacked(generator, mla_shapes(cfg), repeats, device,
                    {"wo": _out_scale(cfg)}, mla_specs(cfg))


def mla_attention(cfg, p: dict, x: torch.Tensor, *, positions: torch.Tensor,
                  cache=None, cache_len=None):
    """Multi-head latent attention, prefill or decode.

    The cache holds only the latent: (c_kv [B, S, kv_lora], k_rope
    [B, S, dr]), bfloat16. Prefill materialises per-head keys and values
    from it and runs the flash scan (dh = dn + dr, dv, no grouping);
    decode is absorbed: ``w_uk`` folded into the query and ``w_uv`` into
    the output, in float32, attending in the latent space to positions
    below ``cache_len + S``. prefill: x [B, S, D] -> (out, (c_kv, k_rope));
    decode: x [B, 1, D] and ``cache`` [B, S_max, ·] -> (out, new caches
    with this step's latent written at ``cache_len``; the caches passed in
    are left as they were).
    """
    m = cfg.mla
    b, sq, _ = x.shape
    tp = tp_region()
    xc = x.to(COMPUTE_DTYPE)
    if tp is not None:    # this rank's heads over a latent every rank has
        xc = C.copy_to_tp(xc, tp[0])
    h = p["w_uq"].shape[1]
    dn, dr = m.nope_head_dim, m.rope_head_dim

    q_in = xc
    if m.q_lora:
        q_in = rms_norm(xc @ p["w_dq"].to(COMPUTE_DTYPE), p["q_norm"],
                        cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bhsk", q_in, p["w_uq"].to(COMPUTE_DTYPE))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rms_norm(xc @ p["w_dkv"].to(COMPUTE_DTYPE), p["kv_norm"],
                    cfg.rms_eps)                             # [B, S, L]
    k_rope = apply_rope(xc @ p["w_kr"].to(COMPUTE_DTYPE), positions,
                        cfg.rope_theta)                      # [B, S, dr]

    if cache is not None:
        # write this step's latent at cache_len (clamped to fit, as
        # ``dynamic_update_slice`` clamps), into copies of the caches
        ckv_cache, kr_cache = (c.clone() for c in cache)
        s_len = ckv_cache.shape[1]
        start = min(max(int(cache_len), 0), s_len - sq)
        ckv_cache[:, start:start + sq] = c_kv.to(ckv_cache.dtype)
        kr_cache[:, start:start + sq] = k_rope.to(kr_cache.dtype)
        q_c = torch.einsum("bhsk,lhk->bhsl", q_nope.float(),
                           p["w_uk"].float())                # [B,H,1,L]
        lat, krc = ckv_cache.float(), kr_cache.float()
        logits = (torch.einsum("bhsl,btl->bhst", q_c, lat)
                  + torch.einsum("bhsk,btk->bhst", q_rope.float(), krc)
                  ) * (1.0 / math.sqrt(dn + dr))
        valid = torch.arange(s_len, device=x.device) < cache_len + sq
        logits = torch.where(valid, logits, float("-inf"))
        pr = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        pr = pr / pr.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        o_lat = torch.einsum("bhst,btl->bhsl", pr, lat)      # [B,H,1,L]
        out = torch.einsum("bhsl,lhv->bhsv", o_lat, p["w_uv"].float())
        new_cache = (ckv_cache, kr_cache)
    else:
        k_nope = torch.einsum("bsl,lhk->bhsk", c_kv,
                              p["w_uk"].to(COMPUTE_DTYPE))
        vfull = torch.einsum("bsl,lhv->bhsv", c_kv,
                             p["w_uv"].to(COMPUTE_DTYPE))
        kr = k_rope[:, None].expand(b, h, sq, dr).to(k_nope.dtype)
        k = torch.cat([k_nope, kr], dim=-1)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k,
                              vfull, causal=True)
        new_cache = (c_kv, k_rope)

    y = torch.einsum("bhsv,hvd->bsd", out.to(COMPUTE_DTYPE),
                     p["wo"].to(COMPUTE_DTYPE))
    if tp is not None:
        y = C.reduce_from_tp(y, tp[0])
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_shapes(cfg, d_ff: int | None = None) -> dict[str, tuple[int, ...]]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def mlp_specs() -> dict[str, tuple]:
    """Logical partition spec of each MLP weight (d_ff over tp)."""
    return {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
            "w_down": ("tp", "fsdp")}


def init_mlp(cfg, generator: torch.Generator, repeats: int, device=None,
             d_ff: int | None = None) -> dict[str, torch.Tensor]:
    """SwiGLU weights stacked [R, ...]: normal·0.02, ``w_down``
    ·0.02/√(2·n_layers)."""
    return _stacked(generator, mlp_shapes(cfg, d_ff), repeats, device,
                    {"w_down": _out_scale(cfg)}, mlp_specs())


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; on a live mesh over this rank's d_ff columns, its output
    all-reduced over tp."""
    tp = tp_region()
    xc = x.to(COMPUTE_DTYPE)
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])
    g = silu(xc @ p["w_gate"].to(COMPUTE_DTYPE))
    u = xc @ p["w_up"].to(COMPUTE_DTYPE)
    y = (g * u) @ p["w_down"].to(COMPUTE_DTYPE)
    if tp is not None:
        y = C.reduce_from_tp(y, tp[0])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of experts (expert-parallel over tp on a live mesh)
# ---------------------------------------------------------------------------

def moe_shapes(cfg) -> dict[str, Any]:
    """Router [d, E], stacked experts ``w_gate``/``w_up`` [E, d, fe] and
    ``w_down`` [E, fe, d], and the shared expert's MLP (width
    n_shared · fe) when the config has one; E padded to a multiple of the
    active tp."""
    mo, d = cfg.moe, cfg.d_model
    e = pad_to(mo.n_experts, get_env().tp_size())
    fe = mo.d_ff_expert or cfg.d_ff
    out: dict[str, Any] = {"router": (d, e), "w_gate": (e, d, fe),
                           "w_up": (e, d, fe), "w_down": (e, fe, d)}
    if mo.n_shared:
        out["shared"] = mlp_shapes(cfg, mo.n_shared * fe)
    return out


def moe_specs(cfg) -> dict[str, Any]:
    """Logical partition spec of each MoE parameter: experts over tp (the
    router replicated), the shared expert as an MLP."""
    out: dict[str, Any] = {"router": (None, None),
                           "w_gate": ("tp", "fsdp", None),
                           "w_up": ("tp", "fsdp", None),
                           "w_down": ("tp", None, "fsdp")}
    if cfg.moe.n_shared:
        out["shared"] = mlp_specs()
    return out


def init_moe(cfg, generator: torch.Generator, repeats: int, device=None
             ) -> dict[str, Any]:
    """MoE weights stacked [R, ...]: the router normal·0.006, experts
    normal·0.02 (``w_down`` ·0.02/√(2·n_layers)), and the shared expert."""
    shapes = moe_shapes(cfg)
    shared = shapes.pop("shared", None)
    out: dict[str, Any] = _stacked(generator, shapes, repeats, device,
                                   {"router": 0.006,
                                    "w_down": _out_scale(cfg)},
                                   moe_specs(cfg))
    if shared is not None:
        out["shared"] = init_mlp(cfg, generator, repeats, device,
                                 d_ff=shared["w_down"][0])
    return out


class Routing(NamedTuple):
    """One MoE call's routing, in token order: the experts each token
    chose [T, k] (int64, by falling probability, the lower index first
    among equal ones), their normalised gates [T, k] float32, and ``keep``
    [T, k] (False where the token's slot at that expert overflowed the
    capacity: the reference's ``keep == False``, a dropped contribution),
    and the router's logits [T, E_pad] float32 (-inf past the real
    experts), whose gap between the k-th and (k+1)-th largest says how
    near a tie the token's choice was."""
    expert_idx: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    capacity: int
    logits: torch.Tensor


_ROUTING_SINKS: list[list[Routing]] = []


@contextlib.contextmanager
def record_routing():
    """Collect the ``Routing`` of every ``moe`` call made inside the block,
    in call order (one a layer and forward). Yields the list they are
    appended to; no host read happens until the caller reads it."""
    sink: list[Routing] = []
    _ROUTING_SINKS.append(sink)
    try:
        yield sink
    finally:   # by identity: two sinks holding the same records are equal
        del _ROUTING_SINKS[next(i for i, s in enumerate(_ROUTING_SINKS)
                                if s is sink)]


_REPLAYS: list[list[torch.Tensor]] = []


@contextlib.contextmanager
def replay_routing(experts):
    """Inside the block the n-th ``moe`` call sends its tokens to the
    experts ``experts[n]`` [T, k] (a recorded ``Routing.expert_idx``, for
    the tokens its worker routes: a dp-split call's own rows) in place of
    its own top-k; gates, capacity slots and the combine follow from them
    as usual. Two runs that round otherwise then choose alike where a
    top-k holds a near-tie, so their outputs differ by rounding alone. A
    call past the end of ``experts`` raises."""
    queue = list(experts)
    _REPLAYS.append(queue)
    try:
        yield
    finally:
        del _REPLAYS[next(i for i, q in enumerate(_REPLAYS) if q is queue)]


def top_k_lower_first(values: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_worker(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor, *, n_real: int,
                top_k: int, capacity: int, norm_topk: bool, e_lo: int = 0,
                tp=None, experts: torch.Tensor | None = None):
    """Tokens x [T, D] through the experts ``[e_lo, e_lo + E_loc)``
    (``w_*``'s first axis; every expert off a live mesh): route over all
    experts, place each kept (token, expert) pair at its rank among the
    expert's tokens in flat token order, run this rank's experts on their
    [capacity, D] buffers, and combine their contributions; on a live mesh
    (``tp``: ``tp_region()``) the float32 combine is all-reduced over tp,
    the reference's ``psum``. ``experts`` [T, k], where given, replaces
    the router's top-k choice (``replay_routing``). Returns (y [T, D]
    float32, aux scalar)."""
    t, d = x.shape
    e_pad = router.shape[1]
    e_loc = w_gate.shape[0]
    dev = x.device
    xc = x.to(COMPUTE_DTYPE)
    if tp is not None:
        xc = C.copy_to_tp(xc, tp[0])

    logits = (xc @ router.to(COMPUTE_DTYPE)).float()
    logits = torch.where(torch.arange(e_pad, device=dev)[None, :] < n_real,
                         logits, float("-inf"))
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    if experts is None:
        gates, eidx = top_k_lower_first(probs, top_k)            # [T, k]
    else:
        eidx = experts.to(dev)
        gates = torch.gather(probs, -1, eidx)
    if norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # slots: a stable sort by expert keeps flat token order within each
    fe_idx = eidx.reshape(-1)
    order = torch.argsort(fe_idx, stable=True)
    se = fe_idx[order]
    stok = order // top_k
    starts = torch.searchsorted(se, torch.arange(e_pad, device=dev))
    pos = torch.arange(t * top_k, device=dev) - starts[se]
    keep = pos < capacity
    local = keep if e_loc == e_pad else (
        keep & (se >= e_lo) & (se < e_lo + e_loc))
    b_e = torch.where(local, se - e_lo, 0)
    b_p = torch.where(local, pos, capacity)                      # overflow
    buf = torch.zeros((e_loc * (capacity + 1), d), dtype=COMPUTE_DTYPE,
                      device=dev)
    buf.index_add_(0, b_e * (capacity + 1) + b_p,
                   xc[stok] * local[:, None].to(COMPUTE_DTYPE))
    buf = buf.view(e_loc, capacity + 1, d)[:, :capacity]

    g = silu(torch.bmm(buf, w_gate.to(COMPUTE_DTYPE)))
    u = torch.bmm(buf, w_up.to(COMPUTE_DTYPE))
    o = torch.bmm(g * u, w_down.to(COMPUTE_DTYPE))               # [E,C,D]

    o_pad = torch.cat([o, o.new_zeros((e_loc, 1, d))], dim=1)
    contrib = o_pad[b_e, b_p] * (gates.reshape(-1)[order] * local
                                 )[:, None].to(o.dtype)
    # back to token order, each token's k terms by ascending expert (the
    # order the reference's scatter-add meets them in), summed in float32
    # one after another: deterministic on every device
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * top_k, device=dev)
    by_expert = torch.argsort(eidx, dim=-1)
    terms = contrib[rank.view(t, top_k).gather(1, by_expert)]    # [T,k,D]
    y = terms[:, 0].float()
    for j in range(1, top_k):
        y = y + terms[:, j].float()
    if tp is not None:
        y = C.reduce_from_tp(y, tp[0])

    if _ROUTING_SINKS:
        keep_tok = torch.empty_like(keep)
        keep_tok[order] = keep
        r = Routing(eidx, gates, keep_tok.view(t, top_k), capacity, logits)
        for sink in _ROUTING_SINKS:
            sink.append(r)

    # Switch-style load-balance aux loss over the real experts
    me = probs[:, :n_real].mean(dim=0)
    # the one-hot by a scatter: ``F.one_hot`` reads its indices' range
    # back to the host off the card, an op a dry run on meta cannot take
    onehot = torch.zeros((t, top_k, e_pad), device=dev).scatter_(
        -1, eidx[..., None], 1.0)[..., :n_real]
    ce = onehot.sum(dim=1).mean(dim=0)
    aux = n_real * (me * ce).sum()
    if tp is not None:   # every tp rank computes it whole: count it once
        aux = C.scale_grad(aux, 1.0 / tp[2])
    return y, aux


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots an expert has for a call of ``n_tokens`` tokens."""
    mo = cfg.moe
    return max(8, int(mo.capacity_factor * n_tokens * mo.top_k
                      / mo.n_experts))


def moe(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux scalar float32): the
    routed experts, capacity-bounded over the call's B·S tokens, plus the
    shared expert.

    On a live mesh, the reference's ``shard_map`` branch: this rank's
    experts (``p``'s shard: ``E_pad / tp`` from ``tp_index · E_pad / tp``)
    over its dp-local tokens, the capacity from their count. ``x`` holds
    this rank's batch rows when the env's batch is split over dp; a batch
    every dp rank holds whole (serving fewer sequences than dp) is split
    here when its B·S tokens divide over dp (the reference's ``dp_ok``),
    and the outputs all-gathered back, else every rank takes all tokens.
    ``aux`` is this dp block's (the train step averages it over dp).
    Inside ``replay_routing`` the experts come from the replay."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    tp = tp_region()
    env = get_env()
    dp = env.dp_size() if tp is not None else 1
    split = (tp is not None and not env.batch_split and dp > 1
             and t % dp == 0 and t >= dp)
    if split:
        t_loc = t // dp
        xt = xt[env.dp_index() * t_loc:(env.dp_index() + 1) * t_loc]
    e_lo = 0 if tp is None else tp[1] * p["w_gate"].shape[0]
    y, aux = _moe_worker(xt, p["router"], p["w_gate"], p["w_up"],
                         p["w_down"], n_real=mo.n_experts, top_k=mo.top_k,
                         capacity=moe_capacity(cfg, xt.shape[0]),
                         norm_topk=True, e_lo=e_lo, tp=tp,
                         experts=_REPLAYS[-1].pop(0) if _REPLAYS else None)
    if split:
        for a in reversed(env.dp):          # row-major: data, then pod
            y = C.all_gather(y, 0, env.group(a))
    y = y.reshape(b, s, d).to(x.dtype)
    if mo.n_shared:
        y = y + mlp(p["shared"], x)
    return y, aux
