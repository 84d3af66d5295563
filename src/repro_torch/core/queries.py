"""Local query primitives (paper §4) on torch tensors.

The learned search against a chunk of partitions is the ``spline_search``
kernel's plain version (``kernels/spline_search.py``), and the point
path's per-query lookup (``lower_bound_at``) is the point kernel's
(``kernels/point_probe.py``); this module holds the windowed gathers'
lookups against each query's candidate partitions, the windowed gathers,
and the global filter's geometry. The ray-casting test is the
``point_in_polygon`` kernel's plain version.

The windowed gathers have no kernel, as in the reference, where they
stay on the XLA gather path under both backends: their work is the
learned interval, not the partition.

Bitwise notes: the interpolation is the kernel module's FMA-matched
``interpolate``; ``torch.round`` rounds half to even like ``jnp.round``,
and ``bounds_on_rows`` truncates where the reference truncates; the
circle distance is ``fma(dx, dx, dy*dy)`` (XLA:CPU's contraction,
measured in tests/test_torch_hazards.py); float-to-int casts happen
only on clamped, in-range values. XLA:CPU reads float32 denormals as
zero and flushes tiny results (``_num``): every coordinate compared or
computed here is flushed, the rects and boxes once, each gathered window
plane once, and every difference, product and distance by ``_num``'s
ops (a difference that is only squared needs none: ``_num.dist2_f32``).
The key step (``keys.quantize``) needs no flush: a value below
2^-126 times the quantization scale (at most 2^bits / 1e-30) stays below
2^-14, so it floors and clamps to the same key either way, and a
denormal bound changes ``v - lo`` only below the rounding of ``v`` unless
the bounds span less than about 2^-90 (tests/test_torch_denormals.py
measures it).
"""
from __future__ import annotations

import torch

from repro_torch._num import (add_f32, dist2_f32, flush_denormals, mul_f32,
                              sub_f32)
from repro_torch.core import keys as K
from repro_torch.kernels.point_in_polygon import (  # noqa: F401
    point_in_polygon_plain as point_in_polygon)
from repro_torch.kernels.point_probe import (  # noqa: F401
    lower_bound_plain, point_in_box)
from repro_torch.kernels.spline_search import interpolate


def lower_bound_at(parts, pid, qkf, *, probe: int):
    """Exact lower_bound of each query key against ITS partition ``pid``.

    parts: full (P, ...) dict; pid (Q,) int64, qkf (Q,) f32. Each query
    compares against its whole (+inf padded) knot row; the knot rows are
    short, so this beats gathering the radix row. Returns (Q,) int64.
    The body is the point kernel's plain lookup (``kernels/point_probe``).
    """
    return lower_bound_plain(parts["knot_keys"], parts["knot_pos"],
                             parts["keys_f"], parts["count"], pid, qkf,
                             probe=probe)


def bounds_on_rows(parts, pid, qk, *, probe: int):
    """lower_bound for several keys per candidate partition, sharing one
    knot row per (query, candidate).

    pid (Q, C) int64; qk (Q, C, T) f32. Returns (Q, C, T) int32. The
    window start truncates the interpolated position (the reference's
    ``astype(int32)``), where ``lower_bound_at`` rounds it."""
    n_pad = parts["keys_f"].shape[1]
    m = parts["knot_keys"].shape[1]
    krow = parts["knot_keys"][pid]                      # (Q, C, m)
    prow = parts["knot_pos"][pid]
    succ = (krow[..., None, :] < qk[..., None]).sum(-1)  # (Q, C, T)
    seg = torch.clamp(succ - 1, 0, m - 2)
    phat = interpolate(qk, torch.gather(krow, 2, seg),
                       torch.gather(krow, 2, seg + 1),
                       torch.gather(prow, 2, seg),
                       torch.gather(prow, 2, seg + 1))
    start = torch.clamp(phat.to(torch.int64) - probe // 2, 0,
                        n_pad - probe)
    cols = start[..., None] + torch.arange(probe, device=pid.device)
    win = parts["keys_f"][pid[..., None, None], cols]   # (Q, C, T, probe)
    pos = start + (win < qk[..., None]).sum(-1)
    cnt = parts["count"][pid].to(torch.int64)[..., None]
    return torch.minimum(pos, cnt).to(torch.int32)


def _window_intervals(parts, boxes, pid, valid, rects, spec, *, cap: int,
                      probe: int, z_depth: int):
    """The windowed gathers' shared phase: clip each query rect to its
    candidate boxes, z-decompose the clipped rect, and find the learned
    [s, e) of every disjoint subinterval.

    boxes (Q, C, 4) candidate boxes; pid, valid (Q, C); rects (Q, 4).
    Returns (rect_e (Q, C, 4), s, e, st (Q, C, S) int32, ok (Q, C),
    act_s (Q, C, S))."""
    qn, c = pid.shape
    n_pad = parts["keys_f"].shape[1]
    rects, boxes = flush_denormals(rects), flush_denormals(boxes)
    rect_e = rects[:, None, :].expand(qn, c, 4)
    xl = torch.maximum(rect_e[..., 0], boxes[..., 0])
    yl = torch.maximum(rect_e[..., 1], boxes[..., 1])
    xh = torch.minimum(rect_e[..., 2], boxes[..., 2])
    yh = torch.minimum(rect_e[..., 3], boxes[..., 3])
    nonempty = (xl <= xh) & (yl <= yh) & valid
    bx, bits = spec.bounds, spec.bits_per_dim
    zero = torch.zeros((), dtype=torch.float32, device=rects.device)

    def q(v, lo, hi):
        return K.quantize(torch.where(nonempty, v, zero), lo, hi, bits)

    zlo, zhi, pv = K.z_split_intervals(
        q(xl, bx[0], bx[2]), q(yl, bx[1], bx[3]), q(xh, bx[0], bx[2]),
        q(yh, bx[1], bx[3]), nonempty, depth=z_depth)
    sn = zlo.shape[-1]
    # each candidate's knot row is gathered once for all 2S bounds
    qk2 = torch.cat([K.keys_to_f32(zlo), K.keys_to_f32(zhi) + 1.0], -1)
    pos2 = bounds_on_rows(parts, pid, qk2, probe=probe)
    s, e = pos2[..., :sn], pos2[..., sn:]
    e = torch.where(pv, e, s)
    ok = (((e - s) <= cap) | ~pv).all(-1) | ~nonempty
    st = torch.clamp(s, 0, max(n_pad - cap, 0))
    act_s = pv & nonempty[..., None]
    return rect_e, s, e, st, ok, act_s


def _gather_mask(parts, pid, rect_e, s, e, st, act_s, cap: int):
    """Window gather of every (query, candidate, subinterval): the
    (Q, C, S, cap) planes wx, wy (flushed, as XLA:CPU reads them), the
    window's partition (Q, C, S, 1) and the in-[s, e), below-count,
    in-rect, active mask. ``rect_e`` is already flushed."""
    p4 = pid[..., None, None]
    posn = st[..., None] + torch.arange(cap, dtype=torch.int32,
                                        device=pid.device)
    cols = posn.to(torch.int64)
    wx = flush_denormals(parts["x"][p4, cols])
    wy = flush_denormals(parts["y"][p4, cols])
    r = rect_e[:, :, None, :, None]                   # (Q, C, 1, 4, 1)
    mask = ((posn >= s[..., None]) & (posn < e[..., None]) &
            (posn < parts["count"][p4]) &
            (wx >= r[..., 0, :]) & (wx <= r[..., 2, :]) &
            (wy >= r[..., 1, :]) & (wy <= r[..., 3, :]) & act_s[..., None])
    return wx, wy, p4, cols, mask


def window_need_at(parts, boxes, pid, valid, rects, spec, *,
                   radix_bits: int, probe: int, z_depth: int = 2):
    """Per-(query, candidate) learned-interval demand, no window gather:
    the need probe behind the executor's tier-bucketed dispatch
    (DESIGN.md §13). It runs the windowed gathers' own
    ``_window_intervals`` (the same clip, z-decomposition and learned
    bounds, so a predicted fit is a fit), with ``cap`` pinned to 1: the
    interval widths do not depend on it.

    Returns (width (Q, C) int32, the widest active subinterval; total
    (Q, C) int32, the active subintervals' summed widths)."""
    del radix_bits
    _, s, e, _, _, act_s = _window_intervals(
        parts, boxes, pid, valid, rects, spec, cap=1, probe=probe,
        z_depth=z_depth)
    w = torch.where(act_s, e - s, 0)
    return w.amax(-1), w.sum(-1, dtype=torch.int32)


def range_window_at(parts, boxes, pid, valid, rects, spec, *, cap: int,
                    radix_bits: int, probe: int, z_depth: int = 2):
    """Windowed range query against each query's candidate partitions.

    pid, valid (Q, C); boxes (Q, C, 4); rects (Q, 4). Returns (counts
    (Q, C) int32, vids (Q, C, S*cap) int32 padded -1, ok (Q, C), wx, wy
    (Q, C, S*cap) f32)."""
    del radix_bits
    qn, c = pid.shape
    rect_e, s, e, st, ok, act_s = _window_intervals(
        parts, boxes, pid, valid, rects, spec, cap=cap, probe=probe,
        z_depth=z_depth)
    wx, wy, p4, cols, mask = _gather_mask(parts, pid, rect_e, s, e, st,
                                          act_s, cap)
    vids = torch.where(mask, parts["vid"][p4, cols], -1)
    # the subintervals are disjoint: per-candidate counts add
    return (mask.sum((-2, -1), dtype=torch.int32),
            vids.reshape(qn, c, -1), ok,
            wx.reshape(qn, c, -1), wy.reshape(qn, c, -1))


def circle_window_at(parts, boxes, pid, valid, rects, circ, spec, *,
                     cap: int, radix_bits: int, probe: int,
                     z_depth: int = 2, materialize: bool = True):
    """Circle variant of the windowed gather (paper Remark 2): the
    distance refine runs inside the gather. ``rects`` are the circles'
    MBRs, ``circ`` (Q, 3) [cx, cy, r]. Returns (counts (Q, C), vids
    (Q, C, S*cap) | None, ok (Q, C)); vids is None unless
    ``materialize``."""
    del radix_bits
    qn, c = pid.shape
    rect_e, s, e, st, ok, act_s = _window_intervals(
        parts, boxes, pid, valid, rects, spec, cap=cap, probe=probe,
        z_depth=z_depth)
    wx, wy, p4, cols, mask = _gather_mask(parts, pid, rect_e, s, e, st,
                                          act_s, cap)
    cc = circ[:, None, None, :, None]                 # (Q, 1, 1, 3, 1)
    dx = wx - cc[..., 0, :]               # only squared: no flush needed
    dy = wy - cc[..., 1, :]
    r = cc[..., 2, :]
    mask = mask & (dist2_f32(dx, dy) <= mul_f32(r, r))
    cnts = mask.sum((-2, -1), dtype=torch.int32)
    if not materialize:
        return cnts, None, ok
    vids = torch.where(mask, parts["vid"][p4, cols], -1)
    return cnts, vids.reshape(qn, c, -1), ok


def gather_delta(parts, pid, valid):
    """Gather (Q, C) candidate partitions' delta buffers and their live
    mask.

    Liveness: slot < dcount AND vid >= 0 AND candidate valid. Every
    query-centric delta probe (range and circle windows, kNN candidates,
    join windows, the point probe) builds on this gather; the partition
    sweeps apply the same rule per row in ``backends.TorchBackend.
    delta_live``: change both together. Returns (dx, dy, dvid (Q, C,
    d_cap), live (Q, C, d_cap) bool); the coordinates are as stored."""
    dv = parts["dvid"][pid]
    slot = torch.arange(dv.shape[-1], dtype=torch.int32, device=pid.device)
    live = ((slot < parts["dcount"][pid][..., None]) & (dv >= 0) &
            valid[..., None])
    return parts["dx"][pid], parts["dy"][pid], dv, live


def delta_window_at(parts, pid, valid, rects, circ=None):
    """Live delta-buffer matches of (Q, C) candidate partitions (the
    delta probe beside the learned window gather, DESIGN.md §11: the
    buffers are small, so a full masked scan is the whole cost).

    pid, valid (Q, C); rects (Q, 4); circ, optional (Q, 3) [cx, cy, r],
    the distance refine. The rect compares read denormals as zero, and
    the distance is XLA:CPU's contracted ``fma(dx, dx, dy*dy)`` against
    ``r*r``, flushed (``_num.dist2_f32``, ``mul_f32``). Returns (counts
    (Q, C) int32, vids (Q, C, d_cap) int32 padded -1)."""
    dx, dy, dv, live = gather_delta(parts, pid, valid)
    r = flush_denormals(rects)[:, None, None, :]
    fx, fy = flush_denormals(dx), flush_denormals(dy)
    m = (live & (fx >= r[..., 0]) & (fx <= r[..., 2]) &
         (fy >= r[..., 1]) & (fy <= r[..., 3]))
    if circ is not None:
        cc = circ[:, None, None, :]
        rr = cc[..., 2]
        # the differences are only squared: no flush needed
        m = m & (dist2_f32(dx - cc[..., 0], dy - cc[..., 1]) <=
                 mul_f32(rr, rr))
    return m.sum(-1, dtype=torch.int32), torch.where(m, dv, -1)


def clip_rect_to_box(rects, box):
    """Intersect (Q, 4) rects with one partition box (4,); an empty
    intersection is an inverted rect. Both are read flushed."""
    rects, box = flush_denormals(rects), flush_denormals(box)
    return torch.stack([torch.maximum(rects[:, 0], box[0]),
                        torch.maximum(rects[:, 1], box[1]),
                        torch.minimum(rects[:, 2], box[2]),
                        torch.minimum(rects[:, 3], box[3])], dim=1)


def clipped_key_range(rects, box, spec):
    """Per-partition (klo_f, khi_f, nonempty) of the clipped rects."""
    cl = clip_rect_to_box(rects, box)
    nonempty = (cl[:, 0] <= cl[:, 2]) & (cl[:, 1] <= cl[:, 3])
    safe = torch.where(nonempty[:, None], cl, torch.zeros_like(cl))
    klo, khi = K.rect_key_range(safe, spec)
    return K.keys_to_f32(klo), K.keys_to_f32(khi), nonempty


# ---------------------------------------------------------------------------
# geometry helpers (global filter phase)
# ---------------------------------------------------------------------------

def circle_mbrs(cx, cy, r):
    """(Q, 4) MBRs [cx - r, cy - r, cx + r, cy + r] of (Q,) circles, as
    XLA:CPU computes them: inputs read flushed, results flushed."""
    cx, cy, r = (flush_denormals(a) for a in (cx, cy, r))
    return torch.stack([sub_f32(cx, r), sub_f32(cy, r), add_f32(cx, r),
                        add_f32(cy, r)], -1)


def rect_overlaps_box(rects, boxes):
    """(Q, P) — axis-aligned overlap test (global filter phase), both
    sides read flushed."""
    rects, boxes = flush_denormals(rects), flush_denormals(boxes)
    xl, yl, xh, yh = (rects[:, 0:1], rects[:, 1:2], rects[:, 2:3],
                      rects[:, 3:4])
    bxl, byl, bxh, byh = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    return (xl <= bxh) & (xh >= bxl) & (yl <= byh) & (yh >= byl)


def box_min_dist2(qx, qy, boxes):
    """(Q, P) squared min distance from points to boxes (kNN pruning),
    in the fused form XLA:CPU gives it inside a program, flushed (the
    clamped differences are only squared: ``_num.dist2_f32``)."""
    zero = torch.zeros((), dtype=qx.dtype, device=qx.device)
    dx = torch.maximum(torch.maximum(boxes[:, 0] - qx[:, None],
                                     qx[:, None] - boxes[:, 2]), zero)
    dy = torch.maximum(torch.maximum(boxes[:, 1] - qy[:, None],
                                     qy[:, None] - boxes[:, 3]), zero)
    return dist2_f32(dx, dy)
