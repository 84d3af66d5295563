"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro.models.moe``: tokens are flattened, their (expert,
rank) pairs sorted, and each expert receives its first `capacity`
tokens through a static-shape slot map. Expert matmuls run as one
(E, C, d) x (E, d, f) batched product. Dropped tokens (over capacity)
fall back to the shared-expert/zero path — standard capacity-factor
semantics.

Router: softmax top-k with probability renormalization (DeepSeek-V2
style) + load-balancing auxiliary loss (returned for the train loop).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, swiglu


def top_k_lowest_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lowest index. ``torch.topk`` does not keep that order (ROADMAP
    "Bitwise hazards"); a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux_loss scalar)."""
    b, t, d = x.shape
    n_tok = b * t
    e = cfg.n_experts
    k = cfg.top_k
    cap = int(max(cfg.capacity_factor * n_tok * k / e, 1))
    # round capacity to a lane-friendly multiple
    cap = -(-cap // 8) * 8
    dev = x.device

    xf = x.reshape(n_tok, d)
    gates = torch.softmax((xf @ p["router"].to(x.dtype)).float(), dim=-1)
    top_p, top_e = top_k_lowest_index(gates, k)            # (N, k)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    # -- load balance aux (Switch-style) --
    me = gates.mean(dim=0)                                 # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1), torch.full((n_tok * k,), 1.0 / (n_tok * k),
                                         dtype=torch.float32, device=dev))
    aux = e * torch.sum(me * ce)

    # -- sort-based, gather-only dispatch --
    flat_e = top_e.reshape(-1)                             # (N*k,) int64
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank of each dispatch within its expert group
    grp_start = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=torch.int64, device=dev),
        side="left")
    rank = torch.arange(n_tok * k, device=dev) - grp_start[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, e * cap))     # drop slot
    tok_of = order // k                                    # source token

    # slot -> source token (+ sentinel row for empty slots). Only dropped
    # dispatches share an index, the sentinel slot e*cap, which the
    # [:-1] below drops, as the reference's scatter does; which of them
    # lands there does not matter.
    slot_src = torch.full((e * cap + 1,), n_tok, dtype=torch.int64,
                          device=dev)
    slot_src[slot] = tok_of
    xf_z = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xf_z[slot_src[:-1]].reshape(e, cap, d)            # gather

    # -- expert compute, batched over the expert axis --
    we1 = p["we1"].to(x.dtype)
    we3 = p["we3"].to(x.dtype)
    we2 = p["we2"].to(x.dtype)
    h = F.silu(torch.bmm(xe, we1))
    h = h * torch.bmm(xe, we3)
    ye = torch.bmm(h, we2)

    # -- gather-only combine: invert the sort, sum each token's k picks --
    ye_flat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))],
                        dim=0)
    val = ye_flat[torch.where(keep, slot, torch.full_like(slot, e * cap))]
    inv = torch.argsort(order)                             # dispatch of
    val_t = val[inv].reshape(n_tok, k, d)                  # each token
    keep_t = keep[inv].reshape(n_tok, k).to(x.dtype)
    out = torch.sum(val_t * (top_p.to(x.dtype) * keep_t)[..., None], dim=1)

    if cfg.n_shared:
        out = out + swiglu(xf, p["ws1"].to(x.dtype), p["ws3"].to(x.dtype),
                           p["ws2"].to(x.dtype))
    return out.reshape(b, t, d), aux
