"""Learned lower-bound search: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/spline_search.py``
(``spline_search``; wrapper ``kernels/ops.py:spline_search``). Source:
``csrc/spline_search.cu``. One launch covers a chunk of partitions; a
group of 16 lanes works on each (query key, partition): lane 0 reads the
radix row, the group locates the segment with a ballot over the knot
window in strides of 16, and counts the probe window's keys below q in
two levels (16 samples at stride ceil(probe / 16), then the keys after
the last sample below q), with coalesced loads.
Bound: latency (four dependent reads per key) and the launch; the byte
bound is far below either.

The plain version is the whole learned search on torch tensors: radix
bucket -> knot window -> segment -> interpolation -> round -> a
``probe``-wide compare-count. ``probe`` (fixed at build from eps and the
longest duplicate-key run) keeps the true lower bound inside every probe
window, so the windowed compare-count reproduces ``searchsorted``. The
kernel's two-level count relies on each ``keys_f`` row being sorted, as
the index builds it (padding 3e38 past the count).

Bitwise notes: the interpolation ``p0 + t*(p1 - p0)`` is the FMA that
XLA:CPU contracts it to (``fma_f32``); ``torch.round`` rounds half to
even like ``jnp.round``; float-to-int casts happen only on clamped,
in-range values. XLA:CPU reads float32 denormals as zero (``_num``), but
no flush is needed here: keys and knots are integer-valued and the
result is an integer position; the only denormal, ``t`` below 2^-126
against a padded knot, cannot move a rounded or truncated position.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._num import fma_f32
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"spline_search_launch": [P, I, P, P, I, P, I, P, P, P, P, P, I,
                                 I, I, I, P, P]}

_TINY = float(np.float32(1e-30))     # jnp.maximum(.., 1e-30) in float32


def interpolate(q, k0, k1, p0, p1):
    """Spline interpolation, bitwise the reference's float32 math."""
    t = torch.clamp((q - k0) / torch.clamp(k1 - k0, min=_TINY), 0.0, 1.0)
    return fma_f32(t, p1 - p0, p0)


def radix_locate(table, kmin, scale, n_knots, q, *, bits: int):
    """Knot-index search bounds [lo, hi] per (partition, query key).

    table (C, 2^b+2) int32; kmin, scale, n_knots (C,); q (Q,) f32.
    Returns (C, Q) int64 lo, hi."""
    j = torch.floor((q[None, :] - kmin[:, None]) * scale[:, None])
    j = torch.clamp(j, 0, 1 << bits).to(torch.int64)
    tab = table.to(torch.int64)
    lo = torch.gather(tab, 1, j)
    hi = torch.gather(tab, 1, j + 1)
    hmax = torch.clamp(n_knots.to(torch.int64) - 1, min=0)[:, None]
    return lo, torch.minimum(torch.maximum(hi, lo), hmax)


def window_start(q, knot_keys, knot_pos, radix_table, n_pad: int, kmin,
                 scale, n_knots, *, probe: int, radix_bits: int):
    """(C, Q) int64 start of each key's probe window: the lookup before
    the compare-count, clamped so the window lies inside the row."""
    m = knot_keys.shape[1]
    lo, hi = radix_locate(radix_table, kmin, scale, n_knots, q,
                          bits=radix_bits)
    # branchless segment locate restricted to the knot window [lo, hi]
    idx = torch.arange(m, device=knot_keys.device)
    in_win = (idx >= lo[..., None]) & (idx <= hi[..., None])
    lt = (knot_keys[:, None, :] < q[None, :, None]) & in_win
    seg = torch.clamp(lo + lt.sum(-1) - 1, min=0)
    seg1 = torch.clamp(seg + 1, max=m - 1)
    phat = interpolate(q[None, :], torch.gather(knot_keys, 1, seg),
                       torch.gather(knot_keys, 1, seg1),
                       torch.gather(knot_pos, 1, seg),
                       torch.gather(knot_pos, 1, seg1))
    return torch.clamp(torch.round(phat).to(torch.int64) - probe // 2,
                       0, n_pad - probe)


def spline_search_plain(q, knot_keys, knot_pos, radix_table, keys_f, kmin,
                        scale, n_knots, count, *, probe: int,
                        radix_bits: int):
    """(C, Q) int32 exact lower bounds (first index with key >= q, capped
    at ``count``) of (Q,) keys against each of C partitions."""
    c, n_pad = keys_f.shape
    start = window_start(q, knot_keys, knot_pos, radix_table, n_pad, kmin,
                         scale, n_knots, probe=probe, radix_bits=radix_bits)
    cols = start[..., None] + torch.arange(probe, device=keys_f.device)
    win = torch.gather(keys_f, 1, cols.reshape(c, -1)).reshape(cols.shape)
    pos = start + (win < q[None, :, None]).sum(-1)
    return torch.minimum(pos, count.to(torch.int64)[:, None]).to(torch.int32)


def spline_search(q, knot_keys, knot_pos, radix_table, keys_f, kmin,
                  scale, n_knots, count, *, probe: int, radix_bits: int):
    """Exact lower bounds of (Q,) float32 keys against each of C
    partitions: (C, Q) int32.

    knot_keys/knot_pos (C, m) f32; radix_table (C, 2^b+2) int32;
    keys_f (C, n_pad) f32; kmin/scale (C,) f32; n_knots/count (C,) int32.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    args = (q, knot_keys, knot_pos, radix_table, keys_f, kmin, scale,
            n_knots, count)
    if on_cpu(*args):
        return spline_search_plain(*args, probe=probe, radix_bits=radix_bits)
    c, m = knot_keys.shape
    r = radix_table.shape[1]
    n_pad = keys_f.shape[1]
    nq = q.shape[0]
    if r != (1 << radix_bits) + 2:
        raise ValueError(f"radix_table width {r} != 2^{radix_bits}+2")
    if not 0 < probe <= n_pad:
        raise ValueError(f"probe {probe} outside (0, n_pad={n_pad}]")
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(q, "q", f32, (nq,)),
            ptr(knot_keys, "knot_keys", f32, (c, m)),
            ptr(knot_pos, "knot_pos", f32, (c, m)),
            ptr(radix_table, "radix_table", i32, (c, r)),
            ptr(kmin, "kmin", f32, (c,)), ptr(scale, "scale", f32, (c,)),
            ptr(n_knots, "n_knots", i32, (c,)),
            ptr(count, "count", i32, (c,)),
            ptr(keys_f, "keys_f", f32, (c, n_pad))]
    out = torch.empty((c, nq), dtype=i32, device=q.device)
    if nq == 0 or c == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("spline_search", _SIG)
    qp, kk, kp, rt, km, sc, nk, cn, kf = ptrs
    err = lib.spline_search_launch(qp, nq, kk, kp, m, rt, r, km, sc, nk, cn,
                                   kf, n_pad, c, probe, radix_bits,
                                   ptr(out, "out", i32, (c, nq)), stream())
    _build.check(lib, "spline_search", err)
    _launches.count(__name__)
    return out
