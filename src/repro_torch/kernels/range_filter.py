"""Range count between learned key bounds: CUDA kernel, plain version,
wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/range_filter.py``
(``range_count``; wrapper ``kernels/ops.py:range_count``). Source:
``csrc/range_filter.cu`` on ``csrc/interval_scan.cuh``. One launch
covers a chunk of partitions: the positions of its active
[s, min(e, count)) intervals are spread evenly over a grid fixed by the
card's SM count (``grid``), so the longest interval no longer sets the
launch's time. Bound: bytes (8 per scanned position).

Bitwise note: XLA:CPU reads float32 denormals as zero, so the rect test
compares both sides flushed (``_num.flush_denormals``; ``daz`` in the
kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch._num import flush_denormals
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"range_count_launch": [P, P, P, P, P, P, P, I, I, I, P, P],
        "range_count_grid": [P]}


def range_mask(rects, s, e, count, x, y, active=None):
    """(C, Q, n_pad) bool — position in [s, e) and below count, point in
    the rect, and (optionally) the (partition, query) pair active: the
    paper's filter phase as a mask."""
    n_pad = x.shape[1]
    posn = torch.arange(n_pad, dtype=torch.int32, device=x.device)
    valid = posn[None, :] < count[:, None]                     # (C, n)
    inpos = (posn >= s[..., None]) & (posn < e[..., None])    # (C, Q, n)
    f = flush_denormals
    px, py = f(x)[:, None, :], f(y)[:, None, :]
    r = f(rects)[None, :, :, None]                             # (1, Q, 4, 1)
    inrect = ((px >= r[:, :, 0]) & (px <= r[:, :, 2]) &
              (py >= r[:, :, 1]) & (py <= r[:, :, 3]))
    m = valid[:, None, :] & inpos & inrect
    if active is not None:
        m = m & active[..., None]
    return m


def range_count_plain(rects, s, e, active, count, x, y):
    """(C, Q) int32 in-rect counts within [s, e) — the mask's row sums."""
    return range_mask(rects, s, e, count, x, y, active).sum(
        -1, dtype=torch.int32)


def range_count(rects, s, e, active, count, x, y):
    """In-rect counts of each query in each of C partitions: (C, Q) int32.

    rects (Q, 4) f32; s, e (C, Q) int32 learned bounds; active (C, Q)
    bool; count (C,) int32; x, y (C, n_pad) f32. CPU tensors run the
    plain version; CUDA tensors launch the kernel.
    """
    args = (rects, s, e, active, count, x, y)
    if on_cpu(*args):
        return range_count_plain(*args)
    c, n_pad = x.shape
    nq = rects.shape[0]
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(rects, "rects", f32, (nq, 4)), ptr(s, "s", i32, (c, nq)),
            ptr(e, "e", i32, (c, nq)),
            ptr(active, "active", torch.bool, (c, nq)),
            ptr(count, "count", i32, (c,)), ptr(x, "x", f32, (c, n_pad)),
            ptr(y, "y", f32, (c, n_pad))]
    out = torch.empty((c, nq), dtype=i32, device=x.device)
    if nq == 0 or c == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("range_filter", _SIG)
    err = lib.range_count_launch(*ptrs, nq, n_pad, c,
                                 ptr(out, "out", i32, (c, nq)), stream())
    _build.check(lib, "range_count", err)
    _launches.count(__name__)
    return out


def grid(device) -> int:
    """Blocks of every launch on the CUDA ``device``, range_count's and
    circle_count's alike (csrc/interval_scan.cuh): the shares a chunk's
    positions are cut into, one per SM."""
    from repro_torch.kernels import _build
    lib = _build.load("range_filter", _SIG)
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        err = lib.range_count_grid(ctypes.byref(out))
    _build.check(lib, "range_count_grid", err)
    return out.value
