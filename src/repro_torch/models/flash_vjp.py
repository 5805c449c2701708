"""Flash attention with a FlashAttention-2-style backward (the counterpart
of ``repro/models/flash_vjp.py``).

Autograd through the online-softmax scan of ``layers.flash_attention``
keeps every block's [B, KV, G, Sq, blk] probabilities for the backward.
``flash_fa2`` keeps only the output and the log-sum-exp of each query and
recomputes each block's probabilities from q and k in the backward, where
``dq`` is carried over the blocks. Plain PyTorch in float32, as the
reference computes it outside any Pallas kernel.

Layout of ``layers.flash_attention``: q [B, H, Sq, dh], k [B, KV, Sk, dh],
v [B, KV, Sk, dv] (dv may differ from dh, as in MLA); H a multiple of KV.
"""
from __future__ import annotations

import math

import torch


def _blocks(x: torch.Tensor, n_blk: int, block: int) -> torch.Tensor:
    """[B, KV, Sk, d] -> [B, KV, n_blk, block, d]."""
    b, kvh, _, d = x.shape
    return x.reshape(b, kvh, n_blk, block, d)


def _causal_bias(i: int, block: int, sq: int, dev) -> torch.Tensor:
    """The additive causal bias [Sq, block] of key block ``i``: 0 where the
    query may see the key, -inf elsewhere."""
    q_pos = torch.arange(sq, device=dev)
    k_pos = i * block + torch.arange(block, device=dev)
    zero = torch.zeros((), device=dev)
    return torch.where(q_pos[:, None] >= k_pos[None, :], zero,
                       float("-inf"))


def _split(q, k, v, block: int):
    b, hq, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    n_blk = max(sk // block, 1)
    block = sk // n_blk
    qf = q.float().reshape(b, kvh, hq // kvh, sq, dh)
    return (qf, _blocks(k.float(), n_blk, block),
            _blocks(v.float(), n_blk, block), n_blk, block)


def _fwd_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, block: int):
    """(out [B, H, Sq, dv] in q's dtype, lse [B, KV, G, Sq] float32)."""
    b, hq, sq, dh = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qf, kb, vb, n_blk, block = _split(q, k, v, block)
    dev = q.device
    m = torch.full(qf.shape[:-1], float("-inf"), device=dev)
    l = torch.zeros(qf.shape[:-1], device=dev)
    acc = torch.zeros(qf.shape[:-1] + (dv,), device=dev)
    for i in range(n_blk):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb[:, :, i]) * scale
        if causal:
            s = s + _causal_bias(i, block, sq, dev)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p,
                                                   vb[:, :, i])
        m = m_new
    lse = m + torch.log(l.clamp(min=1e-30))
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(b, hq, sq, dv)
    return out.to(q.dtype), lse


def _bwd(causal: bool, block: int, q, k, v, out, lse, dout):
    """(dq, dk, dv) in q's, k's and v's dtypes."""
    b, hq, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // kvh
    scale = 1.0 / math.sqrt(dh)
    qf, kb, vb, n_blk, block = _split(q, k, v, block)
    do = dout.float().reshape(b, kvh, g, sq, dv)
    of = out.float().reshape(b, kvh, g, sq, dv)
    delta = torch.sum(do * of, dim=-1)                      # [B,KV,G,Sq]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for i in range(n_blk):
        kblk, vblk = kb[:, :, i], vb[:, :, i]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kblk) * scale
        if causal:
            s = s + _causal_bias(i, block, sq, q.device)
        p = torch.exp(s - lse[..., None])                   # recomputed
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, do))
        dp = torch.einsum("bkgqd,bkcd->bkgqc", do, vblk)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kblk) * scale
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * scale)
    dk = torch.stack(dks, dim=2).reshape(b, kvh, sk, dh)
    dv_ = torch.stack(dvs, dim=2).reshape(b, kvh, sk, dv)
    return (dq.reshape(b, hq, sq, dh).to(q.dtype), dk.to(k.dtype),
            dv_.to(v.dtype))


class _FlashFA2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block: int):
        out, lse = _fwd_core(q, k, v, causal, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block = causal, block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(ctx.causal, ctx.block, q, k, v, out, lse, dout)
        return dq, dk, dv, None, None


def flash_fa2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, block: int) -> torch.Tensor:
    """Attention of q [B, H, Sq, dh] over k [B, KV, Sk, dh], v [B, KV, Sk,
    dv] in ``max(Sk // block, 1)`` key blocks of ``Sk // n_blk`` keys
    (which must split Sk), scores scaled by 1/√dh, causal from query and
    key position 0. Returns [B, H, Sq, dv] in q's dtype; its backward
    recomputes the probabilities from the saved log-sum-exp."""
    return _FlashFA2.apply(q, k, v, causal, block)
