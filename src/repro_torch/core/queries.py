"""Local query primitives (paper §4) on torch tensors.

The learned search against a chunk of partitions is the ``spline_search``
kernel's plain version (``kernels/spline_search.py``); this module holds
the per-query lookup of the point path and the global filter's geometry.

Bitwise notes: the interpolation is the kernel module's FMA-matched
``interpolate``; ``torch.round`` rounds half to even like ``jnp.round``;
float-to-int casts happen only on clamped, in-range values.
"""
from __future__ import annotations

import torch

from repro_torch._num import fma_f32
from repro_torch.kernels.spline_search import interpolate


def lower_bound_at(parts, pid, qkf, *, probe: int):
    """Exact lower_bound of each query key against ITS partition ``pid``.

    parts: full (P, ...) dict; pid (Q,) int64, qkf (Q,) f32. Each query
    compares against its whole (+inf padded) knot row; the knot rows are
    short, so this beats gathering the radix row. Returns (Q,) int64.
    """
    n_pad = parts["keys_f"].shape[1]
    m = parts["knot_keys"].shape[1]
    krow = parts["knot_keys"][pid]                     # (Q, m)
    prow = parts["knot_pos"][pid]
    succ = (krow < qkf[:, None]).sum(1, keepdim=True)
    seg = torch.clamp(succ - 1, 0, m - 2)
    phat = interpolate(qkf[:, None], torch.gather(krow, 1, seg),
                       torch.gather(krow, 1, seg + 1),
                       torch.gather(prow, 1, seg),
                       torch.gather(prow, 1, seg + 1))[:, 0]
    start = torch.clamp(torch.round(phat).to(torch.int64) - probe // 2,
                        0, n_pad - probe)
    win = parts["keys_f"][pid[:, None],
                          start[:, None] + torch.arange(probe,
                                                        device=pid.device)]
    pos = start + (win < qkf[:, None]).sum(1)
    return torch.minimum(pos, parts["count"][pid].to(torch.int64))


# ---------------------------------------------------------------------------
# geometry helpers (global filter phase)
# ---------------------------------------------------------------------------

def rect_overlaps_box(rects, boxes):
    """(Q, P) — axis-aligned overlap test (global filter phase)."""
    xl, yl, xh, yh = (rects[:, 0:1], rects[:, 1:2], rects[:, 2:3],
                      rects[:, 3:4])
    bxl, byl, bxh, byh = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    return (xl <= bxh) & (xh >= bxl) & (yl <= byh) & (yh >= byl)


def point_in_box(qx, qy, boxes):
    """(Q, P) containment of query points in partition boxes."""
    return ((qx[:, None] >= boxes[:, 0]) & (qx[:, None] <= boxes[:, 2]) &
            (qy[:, None] >= boxes[:, 1]) & (qy[:, None] <= boxes[:, 3]))


def box_min_dist2(qx, qy, boxes):
    """(Q, P) squared min distance from points to boxes (kNN pruning)."""
    zero = torch.zeros((), dtype=qx.dtype, device=qx.device)
    dx = torch.maximum(torch.maximum(boxes[:, 0] - qx[:, None],
                                     qx[:, None] - boxes[:, 2]), zero)
    dy = torch.maximum(torch.maximum(boxes[:, 1] - qy[:, None],
                                     qy[:, None] - boxes[:, 3]), zero)
    return fma_f32(dx, dx, dy * dy)
