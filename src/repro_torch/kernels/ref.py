"""Plain PyTorch versions of the kernels in ``ops`` (the counterparts of
``repro.kernels.ref``'s oracles). The CPU path of every wrapper runs these;
the tests hold them against the JAX package and ``chip_smoke.py`` holds
the CUDA kernels against them on the card."""
from __future__ import annotations

import math

import torch


def cumsum_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 0 of an [S, K] array, in its own dtype
    (``torch.cumsum`` would widen int32 to int64).

    Plain version of ``lane_cumsum`` — DFEP's step-1 rank cumsum.
    """
    return torch.cumsum(x, 0, dtype=x.dtype)


def kreduce_min(state: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Masked min over axis 0: [K, V] x [K, V] bool -> [V], ``+inf`` where
    no row is a member.

    Plain version of ``frontier_min`` — the ETSCH aggregation phase.
    """
    return torch.where(member, state, math.inf).amin(dim=0)


def minplus_relax(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  mask: torch.Tensor, cost: float = 1.0) -> torch.Tensor:
    """One undirected min-plus relaxation sweep: for each edge (u, v) with
    ``mask``, out[v] = min(out[v], dist[u]+cost) and out[u] =
    min(out[u], dist[v]+cost). Both candidates come from the input ``dist``
    (Jacobi).

    Plain version of ``minplus_sweep`` — the ETSCH local-computation phase.
    dist [V] float; src/dst [E] int; mask [E] bool.
    """
    s, d = src.long(), dst.long()
    cu = torch.where(mask, dist[s] + cost, math.inf)
    cv = torch.where(mask, dist[d] + cost, math.inf)
    out = dist.clone()
    out.scatter_reduce_(0, d, cu, "amin")
    out.scatter_reduce_(0, s, cv, "amin")
    return out


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                       h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba-1 selective scan, a loop over t:
    ``h_t = exp(-dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗ B_t``,
    ``y_t = C_t · h_t + D ⊙ x_t``.

    Plain version of ``selective_scan``. x/dt [B, S, Di]; b/c [B, S, N];
    a [Di, N] (positive); d_skip [Di]; h0 [B, Di, N] (zero when None), all
    float32. Returns (y [B, S, Di], h_last [B, Di, N]).
    """
    y, h, _ = selective_scan_fwd_ref(x, dt, b, c, a, d_skip, h0)
    return y, h


def selective_scan_fwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
                           d_skip: torch.Tensor,
                           h0: torch.Tensor | None = None, chunk: int = 16
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """:func:`selective_scan_ref` that also returns the state at the start
    of every ``chunk`` steps, [B, ceil(S / chunk), Di, N]: the chunk states
    the scan's backward recomputes from (``selective_scan`` saves them
    under autograd). Returns (y, h_last, chunk states)."""
    bsz, s, d_in = x.shape
    h = (torch.zeros((bsz, d_in, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    ys, states = [], []
    for t in range(s):
        if t % chunk == 0:
            states.append(h)
        dt_t, x_t = dt[:, t], x[:, t]
        decay = torch.exp(-dt_t[:, :, None] * a[None])
        inject = (dt_t * x_t)[:, :, None] * b[:, t, None, :]
        h = decay * h + inject
        ys.append(torch.sum(h * c[:, t, None, :], dim=-1)
                  + x_t * d_skip[None])
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(x)
    hc = (torch.stack(states, dim=1) if states else
          h.new_zeros((bsz, 0) + tuple(h.shape[1:])))
    return y, h, hc


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
                           d_skip: torch.Tensor, hc: torch.Tensor,
                           dy: torch.Tensor,
                           dh_last: torch.Tensor | None = None,
                           chunk: int = 16) -> tuple[torch.Tensor, ...]:
    """Plain version of ``selective_scan_bwd``: the gradients of
    :func:`selective_scan_ref` from the chunk states ``hc`` (as
    :func:`selective_scan_fwd_ref` returns them), ``dy`` [B, S, Di] and
    ``dh_last`` [B, Di, N] (zero when None). Walks the chunks from the
    last, recomputing each chunk's states from its saved state, then its
    steps backwards with ``g_t = dy_t ⊗ C_t + a_{t+1} ⊙ g_{t+1}``.
    Returns (dx, ddt, db, dc, da, dd, dh0)."""
    bsz, s, d_in = x.shape
    carry = (torch.zeros((bsz, d_in, a.shape[1]), dtype=torch.float32,
                         device=x.device) if dh_last is None
             else dh_last.clone())
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(a)
    for ch in reversed(range(hc.shape[1])):
        t0, t1 = ch * chunk, min(s, ch * chunk + chunk)
        hs, decays = [hc[:, ch]], []
        for t in range(t0, t1):
            dt_t, x_t = dt[:, t], x[:, t]
            decays.append(torch.exp(-dt_t[:, :, None] * a[None]))
            inject = (dt_t * x_t)[:, :, None] * b[:, t, None, :]
            hs.append(decays[-1] * hs[-1] + inject)
        for t in reversed(range(t0, t1)):
            k = t - t0
            decay, h_prev, h_t = decays[k], hs[k], hs[k + 1]
            dt_t, x_t, dy_t = dt[:, t], x[:, t], dy[:, t]
            g = dy_t[:, :, None] * c[:, t, None, :] + carry     # [B, Di, N]
            dc[:, t] = torch.sum(dy_t[:, :, None] * h_t, dim=1)
            db[:, t] = torch.sum(g * (dt_t * x_t)[:, :, None], dim=1)
            dx[:, t] = (torch.sum(g * b[:, t, None, :], dim=-1) * dt_t
                        + d_skip[None] * dy_t)
            ddt[:, t] = torch.sum(g * (x_t[:, :, None] * b[:, t, None, :]
                                       - a[None] * decay * h_prev), dim=-1)
            da = da - torch.sum(g * dt_t[:, :, None] * decay * h_prev,
                                dim=0)
            carry = decay * g
    dd = torch.sum(dy * x, dim=(0, 1))
    return dx, ddt, db, dc, da, dd, carry


def selective_scan_bwd_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                                   b: torch.Tensor, c: torch.Tensor,
                                   a: torch.Tensor, d_skip: torch.Tensor,
                                   hc: torch.Tensor, dy: torch.Tensor,
                                   dh_last: torch.Tensor | None = None,
                                   chunk: int = 16, span: int | None = None
                                   ) -> tuple[torch.Tensor, ...]:
    """:func:`selective_scan_bwd_ref`'s result by the decomposition that
    ``csrc/selective_scan_bwd.cu`` computes, every chunk at once. Only the
    tests call it: it holds the kernel's algorithm against the plain
    backward and the reference on the CPU.

    Each chunk is recomputed forward from its saved state; on the way it
    forms P_c = Π a_t and L_c = Σ_t (Π_{s≤t} a_s) dy_t C_t, the carry it
    sends to its left from a zero carry-in, so that with carry K from its
    right it sends P_c ⊙ K + L_c. A reverse scan of these affine maps, in
    log depth over ``span`` chunks (by default the kernel's: a warp walks
    64 / N chunks, two states a lane) and from span to span in turn, gives
    every chunk its true carry-in; then every chunk walks its steps
    backwards once. Steps past S are zero inputs, which leave the state
    and the carry as they are. Returns (dx, ddt, db, dc, da, dd, dh0)."""
    bsz, s, _ = x.shape
    nc = hc.shape[1]
    span = max(1, 64 // a.shape[1]) if span is None else span

    def chunked(t):     # [B, S, W] -> [B, chunks, chunk, W], zeros past S
        t = torch.nn.functional.pad(t, (0, 0, 0, nc * chunk - s))
        return t.reshape(bsz, nc, chunk, t.shape[-1])

    xs, dts, dys, bs, cs = map(chunked, (x, dt, dy, b, c))
    hs, decays = [], []
    h, p, lsum = hc, torch.ones_like(hc), torch.zeros_like(hc)
    for k in range(chunk):
        decay = torch.exp(-dts[:, :, k, :, None] * a)       # [B, C, Di, N]
        h = decay * h + (dts[:, :, k] * xs[:, :, k])[..., None] \
            * bs[:, :, k, None, :]
        p = p * decay
        lsum = lsum + p * (dys[:, :, k, :, None] * cs[:, :, k, None, :])
        hs.append(h)
        decays.append(decay)
    carry = torch.empty_like(hc)
    k_in = torch.zeros_like(hc[:, 0]) if dh_last is None else dh_last
    for s0 in reversed(range(0, nc, span)):
        s1 = min(nc, s0 + span)
        pp, ll = p[:, s0:s1], lsum[:, s0:s1]
        off = 1
        while off < s1 - s0:   # chunk i composes with chunk i + off
            w = s1 - s0 - off
            ll = torch.cat([pp[:, :w] * ll[:, off:] + ll[:, :w],
                            ll[:, w:]], 1)
            pp = torch.cat([pp[:, :w] * pp[:, off:], pp[:, w:]], 1)
            off *= 2
        carry[:, s1 - 1] = k_in
        carry[:, s0:s1 - 1] = pp[:, 1:] * k_in[:, None] + ll[:, 1:]
        k_in = pp[:, 0] * k_in + ll[:, 0]
    dx, ddt = torch.empty_like(xs), torch.empty_like(xs)
    db, dc = torch.empty_like(bs), torch.empty_like(cs)
    da = torch.zeros_like(a)
    for k in reversed(range(chunk)):
        h_prev = hs[k - 1] if k else hc
        g = dys[:, :, k, :, None] * cs[:, :, k, None, :] + carry
        gb = torch.sum(g * bs[:, :, k, None, :], dim=-1)    # [B, C, Di]
        q = g * (decays[k] * h_prev)
        dx[:, :, k] = gb * dts[:, :, k] + d_skip * dys[:, :, k]
        ddt[:, :, k] = xs[:, :, k] * gb - torch.sum(q * a, dim=-1)
        db[:, :, k] = torch.sum(g * (dts[:, :, k] * xs[:, :, k])[..., None],
                                dim=2)
        dc[:, :, k] = torch.sum(dys[:, :, k, :, None] * hs[k], dim=2)
        da = da - torch.sum(dts[:, :, k, :, None] * q, dim=(0, 1))
        carry = decays[k] * g

    def unchunked(t):
        return t.reshape(bsz, nc * chunk, t.shape[-1])[:, :s]

    dd = torch.sum(dy * x, dim=(0, 1))
    return (unchunked(dx), unchunked(ddt), unchunked(db), unchunked(dc), da,
            dd, carry[:, 0])
