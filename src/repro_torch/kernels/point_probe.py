"""Point query — candidate filter, learned lookup and probe scan in one
launch: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/point_probe.py``
(``point_probe``; wrapper ``kernels/ops.py:point_probe``) and the point
program in front of it (reference ``core/local_ops.py`` ``_PointLocal``:
the first-match grid box, then ``queries.lower_bound_at`` and the scan for
that box and for the overflow grid). Source: ``csrc/point_probe.cu``, one
launch per point call. Bound: latency, a chain of dependent reads per
query (box, knot row, lookup window, probe window); the bytes are far
below one launch's floor.

The plain version runs the same program on torch tensors: ``first_box``
(the candidate filter), ``lower_bound_plain`` (the learned lookup, which
``core/queries.lower_bound_at`` calls) and ``point_probe_plain`` (the
window equality scan of the TPU kernel), merged with ``|``.

On a meshed executor the planes hold one shard, the global partitions
[part_offset, part_offset + P_loc), while the boxes stay global: a
candidate outside the shard contributes 0, the others read row
``pid - part_offset`` (the reference's ``probe_pid``: ``lid = pid -
off``, ``mine``). The kernel and the plain version take the same
offset; at offset 0 with every partition held they are the unsharded
program.

Bitwise notes: the interpolation is ``spline_search.interpolate`` (the
FMA XLA:CPU contracts it to); ``torch.round`` rounds half to even like
``jnp.round`` (the kernel's ``rintf``); float-to-int casts happen only
on values in range. XLA:CPU treats float32 denormals as zero (it finds
1e-45 == 0.0), so every coordinate compare here (box test, equality
probe) flushes both sides first (``_num.flush_denormals``). Keys are
integer-valued, and the lookup's only denormal (``t`` below 2^-126,
against a padded knot) cannot move a rounded position.
"""
from __future__ import annotations

import torch

from repro_torch._num import flush_denormals
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream
from repro_torch.kernels.spline_search import interpolate

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"point_query_launch": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                               I, I, P, P]}

def point_in_box(qx, qy, boxes):
    """(Q, P) containment of query points in boxes [xlo, ylo, xhi, yhi],
    edges closed (``core/queries`` re-exports it for the global
    filter)."""
    return ((qx[:, None] >= boxes[:, 0]) & (qx[:, None] <= boxes[:, 2]) &
            (qy[:, None] >= boxes[:, 1]) & (qy[:, None] <= boxes[:, 3]))


def first_box(bounds, qx, qy, overflow: int):
    """(Q,) int64 lowest grid box ``g < overflow`` holding each point (the
    reference's argmax), or ``overflow`` when none does."""
    inb = point_in_box(flush_denormals(qx), flush_denormals(qy),
                       flush_denormals(bounds[:overflow]))     # (Q, G)
    col = torch.arange(inb.shape[1], device=qx.device)
    cand = torch.where(inb, col, overflow)
    return torch.cat([cand, torch.full_like(cand[:, :1], overflow)],
                     1).amin(1)


def lower_bound_plain(knot_keys, knot_pos, keys_f, count, pid, qk, *,
                      probe: int):
    """Exact lower bound of each key ``qk`` (Q,) f32 in ITS partition
    ``pid`` (Q,) int64: the segment by a compare-count over the whole
    padded knot row, the FMA interpolation, the rounded position less
    probe // 2 clamped to [0, n_pad - probe] as the lookup window's start,
    the window's compare-count, capped at the partition's count. Returns
    (Q,) int64."""
    n_pad, m = keys_f.shape[1], knot_keys.shape[1]
    krow = knot_keys[pid]                                       # (Q, m)
    prow = knot_pos[pid]
    succ = (krow < qk[:, None]).sum(1, keepdim=True)
    seg = torch.clamp(succ - 1, 0, m - 2)
    phat = interpolate(qk[:, None], torch.gather(krow, 1, seg),
                       torch.gather(krow, 1, seg + 1),
                       torch.gather(prow, 1, seg),
                       torch.gather(prow, 1, seg + 1))[:, 0]
    start = torch.clamp(torch.round(phat).to(torch.int64) - probe // 2,
                        0, n_pad - probe)
    win = keys_f[pid[:, None],
                 start[:, None] + torch.arange(probe, device=pid.device)]
    pos = start + (win < qk[:, None]).sum(1)
    return torch.minimum(pos, count[pid].to(torch.int64))


def gather_windows(pid, start, probe: int, *planes):
    """Each query's (probe,) window of each (P, n_pad) plane, read from
    its partition ``pid`` at ``start``: tuple of (Q, probe) tensors."""
    cols = start[:, None].to(torch.int64) + torch.arange(
        probe, device=start.device)
    rows = pid[:, None].to(torch.int64)
    return tuple(p[rows, cols] for p in planes)


def count_matches(qk, qx, qy, wk, wx, wy):
    """(Q,) int32 count of window slots equal to the query in key, x, y
    (coordinates compared with denormals flushed)."""
    f = flush_denormals
    m = ((wk == qk[:, None]) & (f(wx) == f(qx)[:, None]) &
         (f(wy) == f(qy)[:, None]))
    return m.sum(1, dtype=torch.int32)


def point_probe_plain(pid, start, qk, qx, qy, keys_f, x, y, *, probe: int):
    """The TPU kernel's function, the scan stage: exact-match counts in
    each query's window [start, start + probe) of partition ``pid``."""
    return count_matches(qk, qx, qy,
                         *gather_windows(pid, start, probe, keys_f, x, y))


def point_query_plain(bounds, knot_keys, knot_pos, keys_f, x, y, count, qx,
                      qy, qk, *, overflow: int, probe: int,
                      part_offset: int = 0):
    """The kernel's function: (Q,) int32, 1 where the point (qx, qy) with
    key qk is in the first grid box holding it or in the overflow grid,
    among the partitions [part_offset, part_offset + P_loc) the planes
    hold."""
    p_loc, n_pad = keys_f.shape
    pid1 = first_box(bounds, qx, qy, overflow)
    found = None
    for pid in (pid1, torch.full_like(pid1, overflow)):
        local = pid - part_offset
        mine = (local >= 0) & (local < p_loc)
        local = torch.clamp(local, 0, p_loc - 1)
        pos = lower_bound_plain(knot_keys, knot_pos, keys_f, count, local,
                                qk, probe=probe)
        start = torch.clamp(pos - probe // 2, 0, n_pad - probe)
        hit = (point_probe_plain(local, start, qk, qx, qy, keys_f, x, y,
                                 probe=probe) > 0) & mine
        found = hit if found is None else found | hit
    return found.to(torch.int32)


def point_query(bounds, knot_keys, knot_pos, keys_f, x, y, count, qx, qy,
                qk, *, overflow: int, probe: int, part_offset: int = 0):
    """Membership of each query point: (Q,) int32, 1 where found.

    bounds (P, 4) f32 boxes of every partition (the grid's first
    ``overflow``); the planes hold the partitions [part_offset,
    part_offset + P_loc): knot_keys, knot_pos (P_loc, m) f32; keys_f, x,
    y (P_loc, n_pad) f32; count (P_loc,) int32; qx, qy, qk (Q,) f32. CPU
    tensors run the plain version; CUDA tensors launch the kernel, one
    warp per (query, candidate).
    """
    args = (bounds, knot_keys, knot_pos, keys_f, x, y, count, qx, qy, qk)
    if on_cpu(*args):
        return point_query_plain(*args, overflow=overflow, probe=probe,
                                 part_offset=part_offset)
    p_loc, n_pad = keys_f.shape
    p_total = bounds.shape[0]
    m = knot_keys.shape[1]
    nq = qk.shape[0]
    if not 0 < probe <= n_pad:
        raise ValueError(f"probe {probe} outside (0, n_pad={n_pad}]")
    if not 0 <= overflow < p_total:
        raise ValueError(f"overflow {overflow} outside [0, {p_total})")
    if not (0 <= part_offset and 0 < p_loc
            and part_offset + p_loc <= p_total):
        raise ValueError(f"shard [{part_offset}, {part_offset + p_loc}) "
                         f"outside [0, {p_total})")
    if m < 2:
        raise ValueError(f"knot row of {m} (needs 2)")
    f32, i32 = torch.float32, torch.int32
    plane = (p_loc, n_pad)
    ptrs = [ptr(bounds, "bounds", f32, (p_total, 4)),
            ptr(knot_keys, "knot_keys", f32, (p_loc, m)),
            ptr(knot_pos, "knot_pos", f32, (p_loc, m)),
            ptr(keys_f, "keys_f", f32, plane), ptr(x, "x", f32, plane),
            ptr(y, "y", f32, plane), ptr(count, "count", i32, (p_loc,)),
            ptr(qx, "qx", f32, (nq,)), ptr(qy, "qy", f32, (nq,)),
            ptr(qk, "qk", f32, (nq,))]
    if bounds.data_ptr() % 16:          # the kernel reads float4 boxes
        raise ValueError("bounds: not aligned to 16 bytes")
    out = torch.empty((nq,), dtype=i32, device=qk.device)
    if nq == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("point_probe", _SIG)
    err = lib.point_query_launch(*ptrs, nq, p_loc, m, n_pad, overflow,
                                 probe, part_offset,
                                 ptr(out, "out", i32, (nq,)), stream())
    _build.check(lib, "point_query", err)
    _launches.count(__name__)
    return out
