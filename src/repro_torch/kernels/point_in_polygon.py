"""Polygon join count (ray-casting refine): CUDA kernel, plain versions,
wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/point_in_polygon.py``
(``point_in_polygon``; wrapper ``kernels/ops.py:point_in_polygon``),
which flags one polygon's containment over a whole partition row and is
launched once per polygon, its flags then ANDed with the range filter's
mask (``PallasBackend.join_scan``). Source: ``csrc/point_in_polygon.cu``
on ``csrc/interval_scan.cuh``, the fused form, as ``range_filter``: one
launch per chunk of partitions spreads the positions of every polygon's
active [s, min(e, count)) intervals evenly over a grid fixed by the
card's SM count (``range_filter.grid``); each position tests the
polygon's MBR and then ray-casts its edges, the vertices read from
global memory (no limit on their number). Counting only the masked
points gives the count of ``mask & inside`` over the whole row.

Bound: operations (about 8 float operations per edge per scanned point
in the MBR) or bytes (8 per scanned position), whichever is larger.

Bitwise notes: XLA:CPU contracts the crossing ``x1 + t*(x2 - x1)`` into
``fma(t, x2 - x1, x1)`` (tests/test_torch_hazards.py measures it); the
division is an IEEE division with the reference's 1e-30 guard when
``y1 == y2``. XLA:CPU reads float32 denormals as zero and flushes tiny
results: the plain version flushes the point, the vertices, the
differences, ``t`` and ``xin`` (``_num``'s ops), and the kernel calls
``daz``/``ftz`` at the same steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._num import (div_f32, flush_denormals, fma_f32,
                              sub_f32)
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream
from repro_torch.kernels.range_filter import range_mask

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"join_count_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, P, P]}

_TINY = float(np.float32(1e-30))


def point_in_polygon_plain(px, py, poly, n_edges):
    """Ray-casting parity flags, bool (..., N).

    px, py (..., N) f32; poly (..., E, 2) f32; n_edges (...,) int. The
    leading axes broadcast. Edges are (poly[i], poly[i+1 mod n_edges]);
    padding edges (i >= n_edges) never cross. The flags equal
    ``kernels/ref.py:point_in_polygon`` of the reference."""
    e_max = poly.shape[-2]
    px, py, poly = (flush_denormals(v) for v in (px, py, poly))
    ne = n_edges.to(torch.int64)[..., None]                   # (..., 1)
    tiny = torch.full((), _TINY, dtype=torch.float32, device=px.device)
    parity = torch.zeros(torch.broadcast_shapes(px.shape, ne.shape),
                         dtype=torch.bool, device=px.device)
    for i in range(e_max):
        x1, y1 = poly[..., i, 0, None], poly[..., i, 1, None]
        # poly[nxt] with nxt = 0 past the last edge; an index past E is
        # clamped, as the reference's gather does
        nxt = torch.where(i + 1 >= ne, 0, min(i + 1, e_max - 1))
        p2 = torch.gather(poly, -2, nxt[..., None].expand(
            *nxt.shape[:-1], 1, 2))
        x2, y2 = p2[..., 0], p2[..., 1]
        cond = (y1 > py) != (y2 > py)
        t = div_f32(sub_f32(py, y1),
                    torch.where(y2 == y1, tiny, sub_f32(y2, y1)))
        xin = fma_f32(t, sub_f32(x2, x1), x1)  # XLA:CPU's contraction
        parity ^= cond & (px < xin) & (i < ne)
    return parity


def join_count_plain(polys, n_edges, mbrs, s, e, active, count, x, y):
    """(C, PG) int32 points of [s, e) in each polygon's MBR and inside
    the polygon: the range filter's mask AND the ray-casting flags."""
    m = range_mask(mbrs, s, e, count, x, y, active)         # (C, PG, n)
    inside = point_in_polygon_plain(x[:, None, :], y[:, None, :],
                                    polys[None], n_edges[None])
    return (m & inside).sum(-1, dtype=torch.int32)


def join_count(polys, n_edges, mbrs, s, e, active, count, x, y):
    """Contained-point counts of each polygon in each of C partitions:
    (C, PG) int32.

    polys (PG, E, 2) f32; n_edges (PG,) int32; mbrs (PG, 4) f32; s, e
    (C, PG) int32 learned bounds of the MBRs' key ranges; active (C, PG)
    bool; count (C,) int32; x, y (C, n_pad) f32. CPU tensors run the
    plain version; CUDA tensors launch the kernel.
    """
    args = (polys, n_edges, mbrs, s, e, active, count, x, y)
    if on_cpu(*args):
        return join_count_plain(*args)
    c, n_pad = x.shape
    pg, e_max = polys.shape[0], polys.shape[1]
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(polys, "polys", f32, (pg, e_max, 2)),
            ptr(n_edges, "n_edges", i32, (pg,)),
            ptr(mbrs, "mbrs", f32, (pg, 4)), ptr(s, "s", i32, (c, pg)),
            ptr(e, "e", i32, (c, pg)),
            ptr(active, "active", torch.bool, (c, pg)),
            ptr(count, "count", i32, (c,)), ptr(x, "x", f32, (c, n_pad)),
            ptr(y, "y", f32, (c, n_pad))]
    if polys.data_ptr() % 8:            # the kernel reads float2 vertices
        raise ValueError("polys: not aligned to 8 bytes")
    out = torch.empty((c, pg), dtype=i32, device=x.device)
    if pg == 0 or c == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("point_in_polygon", _SIG)
    err = lib.join_count_launch(*ptrs, pg, e_max, n_pad, c,
                                ptr(out, "out", i32, (c, pg)), stream())
    _build.check(lib, "join_count", err)
    _launches.count(__name__)
    return out
