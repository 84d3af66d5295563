"""Circle count between learned key bounds: CUDA kernel, plain version,
wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/circle_filter.py``
(``circle_count``; wrapper ``kernels/ops.py:circle_count``). Source:
``csrc/circle_filter.cu`` on ``csrc/interval_scan.cuh``, as
``range_filter``: one launch per chunk of partitions spreads the
positions of the active [s, min(e, count)) intervals evenly over a grid
fixed by the card's SM count (``range_filter.grid``); each position
tests the circle's MBR and then the distance. Bound: bytes (8 per
scanned position).

Bitwise note: XLA:CPU contracts the reference's ``dx*dx + dy*dy`` into
``fma(dx, dx, dy*dy)`` (tests/test_torch_hazards.py measures it), so
the plain version uses ``fma_f32`` and the kernel ``__fmaf_rn``. It
reads float32 denormals as zero and flushes tiny results: the MBR test
compares flushed coordinates (``range_mask``), and the distance flushes
``dy*dy``, the FMA and ``r*r`` (``_num.dist2_f32``, ``mul_f32``; the
kernel's ``daz``, ``dist2_ftz``, ``mul_ftz``). The differences need no
flush: they are only squared (``_num.dist2_f32``).
"""
from __future__ import annotations

import torch

from repro_torch._num import dist2_f32, mul_f32
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream
from repro_torch.kernels.range_filter import range_mask

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"circle_count_launch": [P, P, P, P, P, P, P, P, I, I, I, P, P]}


def in_circle(x, y, circ):
    """(C, Q, n_pad) bool — point within its circle: fma(dx, dx, dy*dy)
    <= r*r, the reference's rounding and flushes. x, y (C, n_pad); circ
    (Q, 3)."""
    dx = x[:, None, :] - circ[None, :, 0, None]
    dy = y[:, None, :] - circ[None, :, 1, None]
    r = circ[None, :, 2, None]            # a denormal r squares to 0
    return dist2_f32(dx, dy) <= mul_f32(r, r)


def circle_count_plain(rects, s, e, circ, active, count, x, y):
    """(C, Q) int32 in-circle counts within [s, e): the range filter's
    mask (rects are the circles' MBRs) AND the distance test."""
    m = range_mask(rects, s, e, count, x, y, active) & in_circle(x, y, circ)
    return m.sum(-1, dtype=torch.int32)


def circle_count(rects, s, e, circ, active, count, x, y):
    """In-circle counts of each circle in each of C partitions: (C, Q)
    int32.

    rects (Q, 4) f32 circle MBRs; s, e (C, Q) int32 learned bounds; circ
    (Q, 3) f32 [cx, cy, r]; active (C, Q) bool; count (C,) int32; x, y
    (C, n_pad) f32. CPU tensors run the plain version; CUDA tensors
    launch the kernel.
    """
    args = (rects, s, e, circ, active, count, x, y)
    if on_cpu(*args):
        return circle_count_plain(*args)
    c, n_pad = x.shape
    nq = rects.shape[0]
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(rects, "rects", f32, (nq, 4)), ptr(s, "s", i32, (c, nq)),
            ptr(e, "e", i32, (c, nq)), ptr(circ, "circ", f32, (nq, 3)),
            ptr(active, "active", torch.bool, (c, nq)),
            ptr(count, "count", i32, (c,)), ptr(x, "x", f32, (c, n_pad)),
            ptr(y, "y", f32, (c, n_pad))]
    out = torch.empty((c, nq), dtype=i32, device=x.device)
    if nq == 0 or c == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("circle_filter", _SIG)
    err = lib.circle_count_launch(*ptrs, nq, n_pad, c,
                                  ptr(out, "out", i32, (c, nq)), stream())
    _build.check(lib, "circle_count", err)
    _launches.count(__name__)
    return out

