"""Chunked linear-attention / SSM scan — shared by RWKV6 and Hymba(SSD).

The port of ``repro.models.linear_attn``. Recurrence (per batch b,
head h):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        S: (Dk, Dv)
    o_t = q_t^T S_t  (+ bonus term for RWKV)

computed chunkwise (chunk L): within a chunk the contributions factor into
an intra-chunk masked (q k^T) v matmul plus a cross-chunk q S_0 term, with
cumulative per-channel decay products, so the sequential depth is T/L.
float32 throughout; the log-decay is clipped to [-60, 0] and the chunking
(``chunk=64``, ``min(chunk, t)``) is the reference's, since the within-
chunk inverse decays ``exp(-cum)`` depend on both.
"""
from __future__ import annotations

import torch


def chunked_linear_attn(q, k, v, logw, *, chunk: int = 64, state=None,
                        bonus=None):
    """q, k: (B,T,H,Dk); v: (B,T,H,Dv); logw: (B,T,H,Dk) log-decay <= 0.

    bonus: optional (H, Dk) RWKV "u" — adds u-weighted CURRENT token
    contribution (o_t += (q_t . (u * k_t)) v_t).
    state: optional initial (B,H,Dk,Dv).
    Returns (out (B,T,H,Dv) f32-accumulated cast to q.dtype,
             final state (B,H,Dk,Dv) f32).
    """
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    lc = min(chunk, t)
    if t % lc:
        raise ValueError(f"chunk {lc} does not divide length {t}")
    n = t // lc

    qf = q.float().reshape(b, n, lc, h, dk)
    kf = k.float().reshape(b, n, lc, h, dk)
    vf = v.float().reshape(b, n, lc, h, dv)
    # clamp so within-chunk inverse decays stay finite
    lw = torch.clamp(logw.float(), -60.0, 0.0).reshape(b, n, lc, h, dk)

    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                            device=q.device)

    idx = torch.arange(lc, device=q.device)
    causal_strict = (idx[:, None] > idx[None, :]).float()

    s = state
    outs = []
    for c in range(n):
        qc, kc, vc, lwc = qf[:, c], kf[:, c], vf[:, c], lw[:, c]
        # cw_t = prod_{j<t} w_j   (exclusive cumulative log-decay)
        cum = torch.cumsum(lwc, dim=1)         # inclusive
        cw_excl = cum - lwc                    # exclusive
        cw_end = cum[:, -1:]                   # (B,1,H,Dk) total decay
        q_t = qc * torch.exp(cw_excl)          # q~
        k_t = kc * torch.exp(-cum)             # k~ (divide by cw_{i+1})
        k_end = kc * torch.exp(cw_end - cum)   # k * (cwL / cw_{i+1})
        # intra-chunk: strict-causal (q~ k~^T) V
        att = torch.einsum("blhd,bmhd->bhlm", q_t, k_t)
        att = att * causal_strict
        intra = torch.einsum("bhlm,bmhv->blhv", att, vc)
        # current-token bonus (RWKV u-term) — the diagonal
        if bonus is not None:
            diag = torch.einsum("blhd,blhd->blh", qc, bonus * kc)
            intra = intra + diag[..., None] * vc
        # cross-chunk: q~ S0
        cross = torch.einsum("blhd,bhdv->blhv", q_t, s)
        # state update: S = diag(cwL) S0 + k_end^T V
        s = (torch.exp(cw_end[:, 0])[..., None] * s +
             torch.einsum("bmhd,bmhv->bhdv", k_end, vc))
        outs.append(intra + cross)
    out = torch.stack(outs, dim=1).reshape(b, t, h, dv)
    return out.to(q.dtype), s


def linear_attn_decode(q, k, v, logw, state, bonus=None):
    """Single-token recurrence. q,k: (B,H,Dk); v: (B,H,Dv);
    state (B,H,Dk,Dv) f32. Returns (out (B,H,Dv), new state)."""
    qf = q.float()
    kf = k.float()
    vf = v.float()
    w = torch.exp(torch.clamp(logw.float(), -60.0, 0.0))
    kv = torch.einsum("bhd,bhv->bhdv", kf, vf)
    if bonus is not None:
        eff = state + bonus[None, :, :, None] * kv
    else:
        eff = state + kv
    out = torch.einsum("bhd,bhdv->bhv", qf, eff)
    new_state = w[..., None] * state + kv
    return out.to(q.dtype), new_state
