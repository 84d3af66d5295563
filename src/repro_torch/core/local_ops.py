"""Local query programs (paper §3-4), one device or one rank of a mesh.

Each class is a program ``fn(parts, bounds, *query_args, axis=None)``
with attribute ``n_query_args``. ``parts`` is the dict of (P_loc, ...)
partition tensors this device holds, ``bounds`` the (P, 4) boxes of
every partition (the global index, replicated).

``axis`` is the merge seam (DESIGN.md §6). ``None`` on one device: every
merge is the identity and this device's first partition is 0. On a
meshed executor it is the partition axis (``launch/mesh.Axis``): the
rank holds partitions [off, off + P_loc) of P, off = ``axis.offset(
P_loc)``, and merges its share with the reference's collectives: a
``psum`` of counts and of the point flags, a ``psum`` of ok flags
compared with the axis size, an ``all_gather1`` of windowed ids and of
kNN candidates (then a top-k, ties to the lowest index), and ``pmax`` /
``psum`` in the need probes. A candidate partition ``pid`` of the global
boxes is read as local row ``pid - off`` where it is this rank's
(``_local``); the sweeps pair local chunk ``lo`` with global columns
``off + lo``. Every merged value is the same on every rank of the axis,
so every host decision taken on one (the strict loop's reads, the kNN
round loop's exit) is taken on all.

Every exact program is staged lookup -> scan -> merge: lookup and scan
come from the backend (core/backends.py: plain PyTorch or the CUDA
kernels), the merge (a sum of counts, an OR of flags, a top-k merge)
stays here. Partition-sweep programs walk the partitions in chunks of
``cfg.part_chunk``; the backend takes a whole chunk per call.

The windowed programs (``_RangeWindowLocal``, ``_CircleWindowLocal``,
``_KnnPrunedLocal``, ``_JoinLocal``) are query-centric: each query picks
its <= cand candidate partitions from the global boxes and gathers only
<= cap positions per learned subinterval (``queries.*_window_at``, plain
PyTorch under both backends). Every output row is a function of its
query row alone, so a call whose (Q, C, S, cap) planes would pass
``cfg.scan_chunk_elems`` runs in query-row chunks with the same result.

When the index has delta buffers (``delta_cap`` > 0, DESIGN.md §11),
every program also probes the live buffered inserts of the partitions it
reads: the point program ORs a probe of each query's two candidates, the
sweeps add the backend's delta stage, and the windowed programs append
``queries.delta_window_at``'s ids (or the buffered kNN candidates) after
each candidate's window ids, as the reference concatenates them. The
probes are elementwise per (query, partition), so each runs once per
call over all rows and partitions (in groups whose planes stay within
``cfg.scan_chunk_elems``) rather than once per chunk: the same values,
far fewer launches. With ``delta_cap`` 0 the probes are skipped, and
every program is the frozen index's.

Serving mode's programs (``_CondFusedLocal``, ``_KnnLadderLocal``) run a
windowed program and its exact fallback with no host read, choosing the
output on the device (``_select``). The need probes (``_WindowNeedLocal``,
``_KnnNeedLocal``) size a wide serving batch's rows for the executor's
tier-bucketed dispatch; like the windowed gathers they have no kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._num import (dist2_f32, flush_denormals, mul_f32,
                              stable_topk)
from repro_torch.core import keys as K
from repro_torch.core import queries as Q
from repro_torch.core.build import LEAVES, LearnedSpatialIndex
from repro_torch.core.plan import EngineConfig
from repro_torch.kernels import knn_topk as _knn
from repro_torch.kernels.point_probe import first_box

EMPTY_BOX = np.asarray([3e38, 3e38, -3e38, -3e38], np.float32)
NEG = _knn.NEG              # empty kNN slot, as the reference's


def pad_partitions(index: LearnedSpatialIndex, multiple: int
                   ) -> LearnedSpatialIndex:
    """Pad the partition axis with empty partitions (never match queries)."""
    p = index.num_partitions
    p_pad = int(np.ceil(p / multiple) * multiple)
    if p_pad == p:
        return index
    extra = p_pad - p

    def pad(a, fill):
        block = torch.full((extra,) + tuple(a.shape[1:]), fill,
                           dtype=a.dtype, device=a.device)
        return torch.cat([a, block], dim=0)

    boxes = torch.as_tensor(np.broadcast_to(EMPTY_BOX, (extra, 4)).copy(),
                            device=index.device)

    def pad_opt(a, fill):
        return None if a is None else pad(a, fill)

    return dataclasses.replace(
        index,
        key=pad(index.key, index.key_spec.sentinel),
        x=pad(index.x, 3e38), y=pad(index.y, 3e38), vid=pad(index.vid, -1),
        count=pad(index.count, 0),
        knot_keys=pad(index.knot_keys, 3e38),
        knot_pos=pad(index.knot_pos, 0.0),
        n_knots=pad(index.n_knots, 0),
        radix_table=pad(index.radix_table, 0),
        radix_kmin=pad(index.radix_kmin, 0.0),
        radix_scale=pad(index.radix_scale, 0.0),
        part_bounds=torch.cat([index.part_bounds, boxes], dim=0),
        delta_key=pad_opt(index.delta_key, index.key_spec.sentinel),
        delta_x=pad_opt(index.delta_x, 3e38),
        delta_y=pad_opt(index.delta_y, 3e38),
        delta_vid=pad_opt(index.delta_vid, -1),
        delta_count=pad_opt(index.delta_count, 0),
        dead=pad_opt(index.dead, 0),
        max_run=pad_opt(index.max_run, 0),
        refit_gen=pad_opt(index.refit_gen, 0),
        # the true overflow grid keeps its pre-padding position
        overflow_pid=index.overflow,
    )


def part_leaf_names(index: LearnedSpatialIndex) -> set:
    """The names ``part_arrays`` gives (no tensor built)."""
    names = {"keys_f", "x", "y", "vid", "count", "knot_keys", "knot_pos",
             "n_knots", "radix_table", "radix_kmin", "radix_scale"}
    if index.delta_cap:
        names |= {"dx", "dy", "dvid", "dcount"}
    return names


def part_arrays(index: LearnedSpatialIndex, leaves=None) -> dict:
    """Dict-of-tensors view of the index (leading axis = partitions).

    The delta-buffer leaves appear only when the index has a nonzero
    delta capacity. ``leaves`` restricts the result to the named subset:
    the executor's update path refreshes only the planes a mutation
    touched, and skips the key plane's float32 cast unless it moved."""
    parts = {
        "x": index.x, "y": index.y, "vid": index.vid, "count": index.count,
        "knot_keys": index.knot_keys, "knot_pos": index.knot_pos,
        "n_knots": index.n_knots, "radix_table": index.radix_table,
        "radix_kmin": index.radix_kmin, "radix_scale": index.radix_scale,
    }
    if index.delta_cap:
        parts.update({"dx": index.delta_x, "dy": index.delta_y,
                      "dvid": index.delta_vid, "dcount": index.delta_count})
    if leaves is None or "keys_f" in leaves:
        parts["keys_f"] = K.keys_to_f32(index.key)
    if leaves is not None:
        return {k: parts[k] for k in leaves}
    return parts


def shard_partitions(index: LearnedSpatialIndex, offset: int,
                     p_loc: int) -> LearnedSpatialIndex:
    """A meshed rank's shard: partition rows [offset, offset + p_loc) of
    every per-partition field (copies, so the whole index is not kept
    alive), with the boxes, the overflow id and the statics global."""
    def rows(a):
        return None if a is None else a[offset:offset + p_loc].clone()

    return dataclasses.replace(
        index, **{f: rows(getattr(index, f)) for f in LEAVES
                  if f != "part_bounds"},
        overflow_pid=index.overflow, part_offset=int(offset),
        part_total=index.num_partitions)


# -- the merge seam: identities at axis=None ------------------------------

def _offset(axis, p_loc: int) -> int:
    return 0 if axis is None else axis.offset(p_loc)


def _psum(x, axis):
    return x if axis is None else axis.psum(x)


def _pmax(x, axis):
    return x if axis is None else axis.pmax(x)


def _gather1(x, axis):
    return x if axis is None else axis.all_gather1(x)


def _ok_merge(okq, axis):
    """Per-query ok flags of every shard: True where all are ok (counted,
    ``psum(ok) == size``, as the reference merges them)."""
    if axis is None:
        return okq
    return axis.psum(okq.to(torch.int32)) == axis.size


def _local(pids, valid, axis, p_loc: int):
    """(local rows, mine) of global candidate partitions ``pids``: this
    rank's row ``pid - off`` clamped into [0, p_loc), and ``valid`` where
    that row is this rank's (``valid`` None: every candidate is valid).
    At axis=None the rows are the pids and ``valid`` is returned as it
    is."""
    if axis is None:
        return pids, valid
    local = pids - axis.offset(p_loc)
    mine = (local >= 0) & (local < p_loc)
    if valid is not None:
        mine = valid & mine
    return torch.clamp(local, 0, p_loc - 1), mine


def _topk_gathered(neg, vid, k: int, axis):
    """Every shard's (Q, k) best merged: gathered shard-major, one top-k
    with ties to the lowest index (``lax.top_k``'s order)."""
    if axis is None:
        return neg, vid
    best, ix = stable_topk(axis.all_gather1(neg), k)
    return best, torch.gather(axis.all_gather1(vid), 1, ix)


def _slices(parts: dict, size: int):
    """Yield (first partition, dict) over consecutive slices of ``size``
    partitions, the last possibly shorter; every leaf is a contiguous
    (size, ...) slice."""
    p = parts["count"].shape[0]
    for lo in range(0, p, size):
        yield lo, {k: v[lo:lo + size] for k, v in parts.items()}


def _chunks(parts: dict, chunk: int):
    """Yield (first partition, chunk dict) over consecutive partition
    chunks of ``chunk`` (fewer partitions: one chunk of them all)."""
    p = parts["count"].shape[0]
    c = min(chunk, p)
    if p % c:
        raise ValueError(f"{p} partitions do not split into chunks of {c}")
    return _slices(parts, c)


def _edge_mask(polys, n_edges):
    e = polys.shape[1]
    return (torch.arange(e, device=polys.device)[None, :, None] <
            n_edges[:, None, None])


def _top_candidates(flags, c: int):
    """First ``c`` true columns per row of (Q, P) flags.

    A stable descending sort of a column-priority score, as the
    reference's ``lax.top_k`` (ties to the lowest index): true columns
    ascending, then false columns ascending. Returns (pids (Q, c) int64,
    valid (Q, c), within (Q,) — True when the row had <= c candidates,
    i.e. the result is complete)."""
    p = flags.shape[1]
    c = min(c, p)
    col = torch.arange(p, dtype=torch.int32, device=flags.device)
    score = torch.where(flags, p - col, 0)
    _, order = stable_topk(score, c)
    valid = torch.gather(flags, 1, order)
    within = flags.sum(1, dtype=torch.int32) <= c
    return order, valid, within


def _compact_ids(vids, keep: int):
    """Order-preserving stream compaction of (Q, W) -1-padded ids to the
    first ``keep`` slots: the running count of valid ids gives each
    output slot its source position (searchsorted on the monotone
    cumsum), so the kept window is one gather. Compacting a compacted
    carry placed BEFORE a raw chunk keeps exactly the first ``keep``
    valid ids in plane order."""
    qn, w = vids.shape
    keep = min(keep, w)
    cum = torch.cumsum((vids >= 0).to(torch.int32), 1, dtype=torch.int32)
    tgt = torch.arange(1, keep + 1, dtype=torch.int32, device=vids.device)
    idx = torch.searchsorted(cum, tgt.expand(qn, keep).contiguous())
    kept = torch.gather(vids, 1, torch.clamp(idx, max=w - 1))
    return torch.where(tgt[None, :] <= cum[:, -1:], kept, -1)


def _keep_window(vids, cnt, cap: int, keep=None):
    """Compact materialized ids to the front, bounded keep width
    (``keep`` overrides the default bound: the chunked circle compaction
    passes the monolithic plane's bound so its output is bitwise the
    unchunked one). Returns (vids (Q, keep), cap_ok (Q,) — True when no
    id was dropped)."""
    w = vids.shape[1]
    if keep is None:
        keep = min(w, max(cap * 8, 256))
    kept = _compact_ids(vids, keep)
    cap_ok = (kept >= 0).sum(1, dtype=torch.int32) == cnt
    return kept, cap_ok


def _chunk_cands(cc: int, *arrays):
    """Split candidate-axis arrays (Q, C, ...) into (nch, Q, cc, ...),
    padding the candidate axis with inactive slots (EMPTY_BOX boxes,
    False masks, pid 0) that can never match."""
    c = arrays[0].shape[1]
    nch = -(-c // cc)
    pad = nch * cc - c

    def prep(a):
        if pad:
            if a.dtype == torch.float32 and a.dim() == 3:   # boxes
                # EMPTY_BOX, filled on the device (no host copy)
                blk = torch.full((a.shape[0], pad, 4), float(EMPTY_BOX[0]),
                                 dtype=a.dtype, device=a.device)
                blk[..., 2:] = float(EMPTY_BOX[2])
            else:
                blk = torch.zeros((a.shape[0], pad) + tuple(a.shape[2:]),
                                  dtype=a.dtype, device=a.device)
            a = torch.cat([a, blk], 1)
        a = a.reshape((a.shape[0], nch, cc) + tuple(a.shape[2:]))
        return a.movedim(1, 0)

    return tuple(prep(a) for a in arrays)


def _delta_knn_planes(parts, pid, qx, qy):
    """The pruned kNN's delta probe, the part no round changes: the
    buffered points of each query's (Q, C) candidate partitions, their
    squared distance (the window's ``fma(dx, dx, dy*dy)``, flushed),
    ids and live mask (``queries.gather_delta``'s rule). Returns (d2,
    vids, live), (Q, C, d_cap) each."""
    dx, dy, dv, live = Q.gather_delta(parts, pid, torch.ones_like(
        pid, dtype=torch.bool))
    # the differences are only squared: no flush needed
    return dist2_f32(dx - qx[:, None, None], dy - qy[:, None, None]), dv, live


def _delta_knn_candidates(planes, active, r):
    """One round's live buffered candidates within radius ``r`` of the
    active (Q, C) candidate partitions, from ``_delta_knn_planes``.
    Returns (counts (Q,), vids (Q, C*d_cap), neg_d2 (Q, C*d_cap))."""
    d2, dv, live = planes
    qn = d2.shape[0]
    inc = live & active[..., None] & (d2 <= mul_f32(r, r)[:, None, None])
    return (inc.sum((1, 2), dtype=torch.int32),
            torch.where(inc, dv, -1).reshape(qn, -1),
            torch.where(inc, -d2, NEG).reshape(qn, -1))


class _LocalFn:
    # True for a program that reads the device on the host while it
    # runs: the executor then runs it eagerly, never as a CUDA graph
    host_reads = False

    def __init__(self, index: LearnedSpatialIndex, cfg: EngineConfig,
                 backend):
        self.kw = dict(radix_bits=index.radix_bits, probe=index.probe)
        self.cfg = cfg
        self.backend = backend
        self.n_pad = index.n_pad
        self.spec = index.key_spec
        self.overflow = index.overflow
        self.p_total = index.global_partitions
        # per (query, candidate, subinterval): the lookup's knot row and
        # probe windows for both ends, beside the cap-wide gather
        self.lookup_elems = 2 * (index.knot_keys.shape[1] + index.probe)
        # 0 skips every delta probe: the frozen index's programs
        self.d_cap = index.delta_cap

    def _delta_group(self, qn: int) -> int:
        """Partitions per delta-stage call: whole multiples of part_chunk
        whose (partitions, qn, d_cap) planes stay within
        ``cfg.scan_chunk_elems`` (at least one chunk)."""
        c = self.cfg.part_chunk
        return c * max(1, self.cfg.scan_chunk_elems //
                       max(1, c * qn * self.d_cap))

    def _delta_sum(self, parts, overlap, stage, off: int = 0):
        """(Q,) int32: ``stage(group, active)``'s (C, Q) delta counts
        summed over every partition held, ``overlap`` (Q, P) the active
        pairs of every partition, ``off`` the first one held. Integer
        sums: the order of the groups moves nothing."""
        acc = torch.zeros(overlap.shape[0], dtype=torch.int32,
                          device=overlap.device)
        for lo, grp in _slices(parts, self._delta_group(overlap.shape[0])):
            lo += off
            act = overlap[:, lo:lo + grp["count"].shape[0]].t()
            acc += stage(grp, act).sum(0, dtype=torch.int32)
        return acc

    def _delta_window(self, parts, bounds, rects, circ=None, axis=None):
        """The windowed programs' delta probe for every row at once: ()
        without delta buffers, else (counts (Q, C), vids (Q, C, d_cap))
        of each row's candidate partitions (the ones ``_rows`` picks)
        that this rank holds, for ``_row_chunks`` to hand each row chunk
        its rows."""
        if not self.d_cap:
            return ()
        pids, valid, _ = _top_candidates(Q.rect_overlaps_box(rects, bounds),
                                         self.cand)
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        return Q.delta_window_at(parts, local, mine, rects, circ=circ)

    def _row_chunks(self, fn, cand: int, cap: int, *q, z_depth: int = 2):
        """``fn(*q)`` on query-row chunks whose windowed planes stay within
        ``cfg.scan_chunk_elems`` elements, outputs concatenated along the
        row axis. Every output row is a function of its query row alone,
        so the result is the unchunked call's. A row chunk's candidate
        planes then fit the same budget, so the chunked circle and kNN
        paths engage only where one row's plane passes it."""
        plane = min(cand, self.p_total) * (
            (1 << z_depth) * (cap + self.lookup_elems) + self.d_cap)
        qn = q[0].shape[0]
        rows = max(1, self.cfg.scan_chunk_elems // plane)
        if rows >= qn:
            return fn(*q)
        outs = [fn(*(a[i:i + rows] for a in q)) for i in range(0, qn, rows)]
        return tuple(torch.cat(col) for col in zip(*outs))


class _PointLocal(_LocalFn):
    """Point probe, query-centric: each query touches only its
    first-match grid partition and the overflow grid (paper Alg. 1). The
    whole program (candidates, lookup, scan, merge) is the backend's
    point_query stage: one kernel launch on the cuda backend. With delta
    buffers, a probe of both candidates' live buffered points (equal
    coordinates, denormals read as zero) is OR-ed after it.

    On a mesh each rank answers for the candidates it holds and the
    flags are summed, as the reference's ``psum`` of its int32 flags: a
    point held both in its grid partition and in the overflow grid, on
    two shards, answers 2 (one shard: 1)."""

    n_query_args = 3

    def __call__(self, parts, bounds, qx, qy, qk, axis=None):
        p_loc = parts["count"].shape[0]
        off = _offset(axis, p_loc)
        found = self.backend.point_query(parts, bounds, qx, qy, qk,
                                         overflow=self.overflow,
                                         probe=self.kw["probe"],
                                         part_offset=off)
        if self.d_cap:
            pid1 = first_box(bounds, qx, qy, self.overflow)
            pids = torch.stack([pid1, torch.full_like(pid1, self.overflow)],
                               1)
            local, mine = _local(pids, torch.ones_like(pids,
                                                       dtype=torch.bool),
                                 axis, p_loc)
            dx, dy, _, live = Q.gather_delta(parts, local, mine)  # (Q, 2, d)
            fx, fy = flush_denormals(qx), flush_denormals(qy)
            hit = (live & (flush_denormals(dx) == fx[:, None, None]) &
                   (flush_denormals(dy) == fy[:, None, None])).any((1, 2))
            found = found | hit.to(found.dtype)
        return _psum(found, axis)                           # merge


class _RangeCountLocal(_LocalFn):
    """Exact range count: every chunk's learned [s, e) bounds, then the
    masked in-rect count; a (query, partition) pair whose boxes do not
    overlap is inactive and counts 0."""

    n_query_args = 3

    def __call__(self, parts, bounds, rects, klo, khi, axis=None):
        bk = self.backend
        off = _offset(axis, parts["count"].shape[0])
        overlap = Q.rect_overlaps_box(rects, bounds)          # (Q, P)
        acc = torch.zeros(rects.shape[0], dtype=torch.int32,
                          device=rects.device)
        for lo, ch in _chunks(parts, self.cfg.part_chunk):
            c = ch["count"].shape[0]
            lo += off                                         # global
            act = overlap[:, lo:lo + c].t().contiguous()      # (C, Q)
            s, e = bk.bounds(ch, klo, khi, **self.kw)         # lookup
            cnt = bk.range_scan(ch, rects, s, e, active=act)  # scan
            acc += cnt.sum(0, dtype=torch.int32)              # merge
        if self.d_cap:
            acc += self._delta_sum(parts, overlap, lambda g, a: bk.delta_scan(
                g, rects, active=a), off)
        return _psum(acc, axis)


class _CircleCountLocal(_LocalFn):
    """Exact full-refine circle count (the adaptive circle's fallback):
    every chunk's learned [s, e) bounds of the circles' MBR keys, then
    the backend's circle scan."""

    n_query_args = 4

    def __call__(self, parts, bounds, rects, klo, khi, circ, axis=None):
        bk = self.backend
        off = _offset(axis, parts["count"].shape[0])
        overlap = Q.rect_overlaps_box(rects, bounds)          # (Q, P)
        acc = torch.zeros(rects.shape[0], dtype=torch.int32,
                          device=rects.device)
        for lo, ch in _chunks(parts, self.cfg.part_chunk):
            c = ch["count"].shape[0]
            lo += off                                         # global
            act = overlap[:, lo:lo + c].t().contiguous()      # (C, Q)
            s, e = bk.bounds(ch, klo, khi, **self.kw)         # lookup
            cnt = bk.circle_scan(ch, rects, s, e, circ, active=act)
            acc += cnt.sum(0, dtype=torch.int32)              # merge
        if self.d_cap:
            acc += self._delta_sum(parts, overlap, lambda g, a: bk.delta_scan(
                g, rects, circ=circ, active=a), off)
        return _psum(acc, axis)


class _RangeWindowLocal(_LocalFn):
    """Query-centric windowed range query (the paper's two-phase shape):
    the <= cand candidate partitions per query from the global boxes,
    then only each candidate's learned key subintervals (cap slots
    each). Returns (counts, vids (Q, keep) -1-padded, ok)."""

    n_query_args = 3

    def __init__(self, index, cfg, backend, cap, cand):
        super().__init__(index, cfg, backend)
        self.cap = min(cap, index.n_pad)
        self.cand = cand

    def __call__(self, parts, bounds, rects, klo, khi, axis=None):
        del klo, khi   # recomputed per candidate with clipping
        return self._row_chunks(
            lambda r, *d: self._rows(parts, bounds, r, *d, axis=axis),
            self.cand, self.cap, rects,
            *self._delta_window(parts, bounds, rects, axis=axis))

    def _rows(self, parts, bounds, rects, *delta, axis=None):
        qn = rects.shape[0]
        overlap = Q.rect_overlaps_box(rects, bounds)
        pids, valid, within = _top_candidates(overlap, self.cand)
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        cnts, vids, ok, _, _ = Q.range_window_at(
            parts, bounds[pids], local, mine, rects, self.spec,
            cap=self.cap, **self.kw)
        if delta:                  # this row chunk's delta probe
            cnts = cnts + delta[0]
            vids = torch.cat([vids, delta[1]], -1)
        cnt = _psum(cnts.sum(1, dtype=torch.int32), axis)
        okq = _ok_merge((ok | ~mine).all(1), axis)
        vids = _gather1(vids.reshape(qn, -1), axis)
        vids, cap_ok = _keep_window(vids, cnt, self.cap)
        return cnt, vids, okq & within & cap_ok


class _CircleWindowLocal(_LocalFn):
    """Windowed circle query: the distance refine (paper Remark 2) runs
    inside the per-subinterval window gather (Q.circle_window_at). Exact
    when ok; the executor escalates, or falls back to _CircleCountLocal.
    Returns (counts, ok), or (counts, vids, ok) when materializing."""

    n_query_args = 4

    def __init__(self, index, cfg, backend, cap, cand,
                 materialize: bool):
        super().__init__(index, cfg, backend)
        self.cap = min(cap, index.n_pad)
        self.cand = cand
        self.materialize = materialize

    def __call__(self, parts, bounds, rects, klo, khi, circ, axis=None):
        del klo, khi   # recomputed per candidate with clipping
        return self._row_chunks(
            lambda r, cr, *d: self._rows(parts, bounds, r, cr, *d,
                                         axis=axis),
            self.cand, self.cap, rects, circ,
            *self._delta_window(parts, bounds, rects, circ, axis=axis))

    def _rows(self, parts, bounds, rects, circ, *delta, axis=None):
        qn = rects.shape[0]
        overlap = Q.rect_overlaps_box(rects, bounds)
        pids, valid, within = _top_candidates(overlap, self.cand)
        boxes = bounds[pids]
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        c = pids.shape[1]
        cc = max(1, self.cfg.scan_chunk_elems //
                 max(1, qn * (4 * self.cap + self.d_cap)))
        if self.materialize and cc < c:
            return self._chunked(parts, rects, circ, boxes, local, mine,
                                 within, cc, axis)
        cnts, vids, ok = Q.circle_window_at(
            parts, boxes, local, mine, rects, circ, self.spec,
            cap=self.cap, materialize=self.materialize, **self.kw)
        if delta:                  # this row chunk's delta probe
            cnts = cnts + delta[0]
            if self.materialize:
                vids = torch.cat([vids, delta[1]], -1)
        cnt = _psum(cnts.sum(1, dtype=torch.int32), axis)
        okq = _ok_merge((ok | ~mine).all(1), axis)
        if not self.materialize:
            return cnt, okq & within
        vids = _gather1(vids.reshape(qn, -1), axis)
        vids, cap_ok = _keep_window(vids, cnt, self.cap)
        return cnt, vids, okq & within & cap_ok

    def _chunked(self, parts, rects, circ, boxes, pids, valid, within,
                 cc: int, axis=None):
        """Streaming compaction over candidate chunks of ``cc``: a
        front-compacted (Q, keep) id carry, so the materialized plane
        never exceeds O(keep + chunk) per query. Bitwise the monolithic
        path: compaction keeps plane order, the carry precedes each
        chunk, and the final width bound is the monolithic plane's. Each
        candidate chunk probes its own delta buffers (its ids follow the
        chunk's window ids, as in the monolithic plane)."""
        qn = rects.shape[0]
        # the monolithic plane's width
        w_loc = boxes.shape[1] * (4 * self.cap + self.d_cap)
        keep_loc = min(w_loc, max(self.cap * 8, 256))
        kept = torch.full((qn, keep_loc), -1, dtype=torch.int32,
                          device=rects.device)
        cnt = torch.zeros(qn, dtype=torch.int32, device=rects.device)
        okq = torch.ones(qn, dtype=torch.bool, device=rects.device)
        for bx, lc, mn in zip(*_chunk_cands(cc, boxes, pids, valid)):
            cnts, vids, ok = Q.circle_window_at(
                parts, bx, lc, mn, rects, circ, self.spec, cap=self.cap,
                materialize=True, **self.kw)
            if self.d_cap:
                dcnts, dvids = Q.delta_window_at(parts, lc, mn, rects,
                                                 circ=circ)
                cnts = cnts + dcnts
                vids = torch.cat([vids, dvids], -1)
            kept = _compact_ids(torch.cat([kept, vids.reshape(qn, -1)], 1),
                                keep_loc)
            cnt = cnt + cnts.sum(1, dtype=torch.int32)
            okq = okq & (ok | ~mn).all(1)
        cnt = _psum(cnt, axis)
        okq = _ok_merge(okq, axis)
        keep_fin = keep_loc
        if axis is not None:
            # each shard's carry is compacted losslessly up to keep_loc,
            # at least the final bound: gathered shard-major and compacted
            # again, it keeps the ids the monolithic gather would keep
            kept = axis.all_gather1(kept)
            keep_fin = min(axis.size * w_loc, max(self.cap * 8, 256))
        kept, cap_ok = _keep_window(kept, cnt, self.cap, keep=keep_fin)
        return cnt, kept, okq & within & cap_ok


class _KnnExactLocal(_LocalFn):
    """Exact kNN over every partition: per-chunk candidates from the
    backend, streamed into a running top-k (ties to the lowest index,
    carry first, so the result equals one top-k over all points in
    partition order). Each partition's buffered candidates follow its
    main-plane ones, as the reference concatenates them."""

    n_query_args = 2

    def __init__(self, index, cfg, backend, k):
        super().__init__(index, cfg, backend)
        self.k = k

    def __call__(self, parts, bounds, qx, qy, axis=None):
        qn, k = qx.shape[0], self.k
        bk = self.backend
        neg = torch.full((qn, k), -3e38, dtype=torch.float32,
                         device=qx.device)
        vid = torch.full((qn, k), -1, dtype=torch.int32, device=qx.device)
        g = self._delta_group(qn) if self.d_cap else parts["count"].shape[0]
        for _, grp in _slices(parts, g):
            if self.d_cap:         # the group's buffered candidates
                dn, dv = bk.delta_knn_scan(grp, qx, qy)
            for lo, ch in _chunks(grp, self.cfg.part_chunk):
                cn, cv = bk.knn_scan(ch, qx, qy, k)           # (C, Q, W)
                if self.d_cap:
                    c = ch["count"].shape[0]
                    cn = torch.cat([cn, dn[lo:lo + c]], 2)
                    cv = torch.cat([cv, dv[lo:lo + c]], 2)
                cn = cn.transpose(0, 1).reshape(qn, -1)
                cv = cv.transpose(0, 1).reshape(qn, -1)
                neg, vid = bk.topk_merge(neg, vid, cn, cv, k)  # merge
        return _topk_gathered(neg, vid, k, axis)


class _KnnPrunedLocal(_LocalFn):
    """Paper §4.3, query-centric: density-estimated radius, windowed
    range gather over the <= cand nearest candidate partitions, radius
    doubling until >= k verified in-circle candidates. Exact when ok;
    the executor falls back to the exact scan per unresolved query.

    The reference's ``lax.while_loop`` stops once every row is done.
    Here it is a Python loop in one of two forms, chosen by the caller:

    * strict (``fixed_rounds=False``): it reads ``all(done)`` on the
      host once per round and stops early, as strict mode allows;
    * serving (``fixed_rounds=True``, inside a fused program): exactly
      ``cfg.knn_max_rounds`` rounds, no host read. A done row never
      changes again (``newly`` needs ``~done``, and ``r`` freezes on
      ``done``), so the rounds after every row is done leave
      ``(bn, bv, okc, done)`` as they were: the result is bitwise the
      early-exit loop's.

    Returns (neg_d2 (Q, k), vid (Q, k), ok (Q,))."""

    n_query_args = 3

    def __init__(self, index, cfg, backend, k, cand, cap,
                 fixed_rounds: bool = False):
        super().__init__(index, cfg, backend)
        self.k = k
        self.cand = cand
        self.cap = min(cap, index.n_pad)
        self.fixed_rounds = fixed_rounds
        self.host_reads = not fixed_rounds     # the strict form's exit

    def __call__(self, parts, bounds, qx, qy, r0, axis=None):
        return self._row_chunks(
            lambda a, b, r: self._rows(parts, bounds, a, b, r, axis),
            self.cand, self.cap, qx, qy, r0)

    def _round(self, parts, boxes, local, active, rects, r, qx, qy):
        """One candidate plane: in-circle (neg_d2, vid) planes (Q, W),
        in-circle counts and per-candidate ok."""
        qn = qx.shape[0]
        _, vids, ok, wx, wy = Q.range_window_at(
            parts, boxes, local, active, rects, self.spec, cap=self.cap,
            **self.kw)
        # only squared: no flush needed (_num.dist2_f32)
        dx = wx - qx[:, None, None]
        dy = wy - qy[:, None, None]
        d2 = dist2_f32(dx, dy)                     # XLA:CPU's contraction
        inc = (vids >= 0) & (d2 <= mul_f32(r, r)[:, None, None])
        negd = torch.where(inc, -d2, NEG).reshape(qn, -1)
        wv = torch.where(inc, vids, -1).reshape(qn, -1)
        return (negd, wv, inc.sum((1, 2), dtype=torch.int32),
                (ok | ~active).all(1))

    def _rows(self, parts, bounds, qx, qy, r0, axis=None):
        qn, k = qx.shape[0], self.k
        bk = self.backend
        dev = qx.device
        boxd2 = Q.box_min_dist2(qx, qy, bounds)             # (Q, P)
        # the cand nearest partitions by box distance, ties to the
        # lowest index (lax.top_k's order)
        negd2, order = stable_topk(-boxd2, min(self.cand, boxd2.shape[1]))
        cand = order.shape[1]
        cand_d2 = -negd2
        boxes = bounds[order]
        # the candidates this rank holds, as its local rows (None: all)
        local, inshard = _local(order, None, axis, parts["count"].shape[0])
        if axis is not None:
            order = local
        # per-chunk candidate plane (Q, cc * 4*cap); when the whole
        # (Q, cand * 4*cap) plane fits, one top-k over it instead
        cc = max(1, self.cfg.scan_chunk_elems // max(1, qn * 4 * self.cap))
        # the buffered candidates' distances: the same in every round
        dplanes = (_delta_knn_planes(parts, order, qx, qy) if self.d_cap
                   else None)

        def empty():
            return (torch.full((qn, k), NEG, dtype=torch.float32,
                               device=dev),
                    torch.full((qn, k), -1, dtype=torch.int32, device=dev))

        def round_chunked(r, rects, active):
            """Fold candidate chunks into a running (Q, k) best set:
            bitwise the monolithic top-k (the carry precedes each chunk,
            and empty carry slots equal masked plane slots); the delta
            candidates merge last, as they follow the main plane in the
            monolithic concatenation."""
            bn, bv = empty()
            cnt = torch.zeros(qn, dtype=torch.int32, device=dev)
            okl = torch.ones(qn, dtype=torch.bool, device=dev)
            for bx, lc, ac in zip(*_chunk_cands(cc, boxes, order, active)):
                negd, wv, c_in, ok = self._round(parts, bx, lc, ac, rects,
                                                 r, qx, qy)
                bn, bv = bk.topk_merge(bn, bv, negd, wv, k)
                cnt = cnt + c_in
                okl = okl & ok
            if self.d_cap:
                dcnts, dvids, dd2 = _delta_knn_candidates(dplanes, active, r)
                bn, bv = bk.topk_merge(bn, bv, dd2, dvids, k)
                cnt = cnt + dcnts
            return bn, bv, cnt, okl

        def round_monolithic(r, rects, active):
            negd, wv, cnt, okl = self._round(parts, boxes, order, active,
                                             rects, r, qx, qy)
            if self.d_cap:
                # buffered candidates of the same partitions: an insert
                # is in the circle iff within r (coverage already holds
                # every partition within r as a candidate)
                dcnts, dvids, dd2 = _delta_knn_candidates(dplanes, active, r)
                negd = torch.cat([negd, dd2], 1)
                wv = torch.cat([wv, dvids], 1)
                cnt = cnt + dcnts
            bn, ix = stable_topk(negd, k)
            return bn, torch.gather(wv, 1, ix), cnt, okl

        def gather_round(r):
            rects = Q.circle_mbrs(qx, qy, r)
            rr = mul_f32(r, r)[:, None]
            active = cand_d2 <= rr
            if inshard is not None:
                active = active & inshard
            # coverage: every partition within r must be a candidate
            covered = (boxd2 <= rr).sum(1, dtype=torch.int32) <= cand
            rnd = round_chunked if cc < cand else round_monolithic
            bn, bv, cnt, okl = rnd(r, rects, active)
            okq = okl & covered
            if axis is not None:       # every shard's round, merged
                bn, bv = _topk_gathered(bn, bv, k, axis)
                cnt = axis.psum(cnt)
                okq = _ok_merge(okq, axis)
            return bn, bv, okq, cnt

        rounds, r = 0, r0
        done = torch.zeros(qn, dtype=torch.bool, device=dev)
        okc = torch.zeros(qn, dtype=torch.bool, device=dev)
        bn, bv = empty()
        while rounds < self.cfg.knn_max_rounds:
            # the strict form's early exit: a host read per round, not
            # counted in Executor.host_syncs because the reference's
            # loop reads ``done`` on the device
            if not self.fixed_rounds and bool(done.all()):
                break
            bn2, bv2, ok2, cnt2 = gather_round(r)
            newly = (cnt2 >= k) & ok2 & ~done
            bn = torch.where(newly[:, None], bn2, bn)
            bv = torch.where(newly[:, None], bv2, bv)
            okc = okc | newly
            done = done | newly | ~ok2        # overflow -> fallback
            r = torch.where(done, r, r * 2.0)
            rounds += 1
        return bn, bv, okc & done


class _JoinLocal(_LocalFn):
    """Query-centric windowed broadcast join: per polygon, gather only
    the learned MBR subintervals of its <= cand candidate partitions and
    ray-cast those points. Returns (counts (PG,), ok (PG,))."""

    n_query_args = 3

    def __init__(self, index, cfg, backend, cap, cand):
        super().__init__(index, cfg, backend)
        self.cap = min(cap, index.n_pad)
        self.cand = cand

    def __call__(self, parts, bounds, polys, n_edges, mbr_k, axis=None):
        return self._row_chunks(
            lambda pl, ne, mk, *d: self._rows(parts, bounds, pl, ne, mk, *d,
                                              axis=axis),
            self.cand, self.cap, polys, n_edges, mbr_k,
            *self._delta_join(parts, bounds, mbr_k[:, :4], axis), z_depth=3)

    def _delta_join(self, parts, bounds, mbrs, axis=None):
        """The delta probe of every polygon's candidate partitions: ()
        without delta buffers, else the buffered points' (dx, dy (PG, C,
        d_cap), vids -1 outside the polygon's MBR), for the ray cast."""
        if not self.d_cap:
            return ()
        pids, valid, _ = _top_candidates(Q.rect_overlaps_box(mbrs, bounds),
                                         self.cand)
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        dxw, dyw, dvw, live = Q.gather_delta(parts, local, mine)
        r = flush_denormals(mbrs)[:, None, None, :]
        fx, fy = flush_denormals(dxw), flush_denormals(dyw)
        inm = (live & (fx >= r[..., 0]) & (fx <= r[..., 2]) &
               (fy >= r[..., 1]) & (fy <= r[..., 3]))
        return dxw, dyw, torch.where(inm, dvw, -1)

    def _rows(self, parts, bounds, polys, n_edges, mbr_k, *delta,
              axis=None):
        pg = polys.shape[0]
        mbrs = mbr_k[:, :4]
        overlap = Q.rect_overlaps_box(mbrs, bounds)
        pids, valid, within = _top_candidates(overlap, self.cand)
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        _, vids, ok, wx, wy = Q.range_window_at(
            parts, bounds[pids], local, mine, mbrs, self.spec,
            cap=self.cap, z_depth=3, **self.kw)
        if delta:                  # this row chunk's delta probe
            wx, wy, vids = (torch.cat([a, d], -1) for a, d in
                            zip((wx, wy, vids), delta))
        inside = Q.point_in_polygon(wx.reshape(pg, -1), wy.reshape(pg, -1),
                                    polys, n_edges)
        cnt = ((vids.reshape(pg, -1) >= 0) & inside).sum(1,
                                                          dtype=torch.int32)
        return (_psum(cnt, axis),
                _ok_merge((ok | ~mine).all(1), axis) & within)


class _JoinFullLocal(_LocalFn):
    """Exact full-refine join (the windowed join's fallback): every
    chunk's learned [s, e) bounds of the polygons' MBR keys, then the
    backend's join scan."""

    n_query_args = 3

    def __call__(self, parts, bounds, polys, n_edges, mbr_k, axis=None):
        bk = self.backend
        off = _offset(axis, parts["count"].shape[0])
        mbrs, klo, khi = mbr_k[:, :4], mbr_k[:, 4], mbr_k[:, 5]
        overlap = Q.rect_overlaps_box(mbrs, bounds)            # (PG, P)
        acc = torch.zeros(polys.shape[0], dtype=torch.int32,
                          device=polys.device)
        for lo, ch in _chunks(parts, self.cfg.part_chunk):
            c = ch["count"].shape[0]
            lo += off                                          # global
            act = overlap[:, lo:lo + c].t().contiguous()       # (C, PG)
            s, e = bk.bounds(ch, klo.contiguous(), khi.contiguous(),
                             **self.kw)                        # lookup
            cnt = bk.join_scan(ch, polys, n_edges, mbrs, s, e, active=act)
            acc += cnt.sum(0, dtype=torch.int32)               # merge
        if self.d_cap:
            acc += self._delta_sum(parts, overlap, lambda g, a:
                                   bk.delta_join_scan(g, polys, n_edges,
                                                      mbrs, active=a), off)
        return _psum(acc, axis)


class _WindowNeedLocal(_LocalFn):
    """The rect families' need probe (DESIGN.md §13): per query, the
    number of overlapping partitions and the learned-interval demand of
    its windowed gather, with no window gather and no refine. The
    executor reads it once per wide batch to give each row the lowest
    tier it fits.

    Returns (Q, 3) int32 [ncand, need, needsum]: ncand the overlapping
    partitions (a tier fits when ncand <= cand), need the widest
    subinterval over the candidates (fits when need <= cap), needsum the
    summed widths (bounds the materialized plane for the keep width)."""

    def __init__(self, index, cfg, backend, cand, rect_of,
                 n_query_args: int, z_depth: int = 2):
        super().__init__(index, cfg, backend)
        self.cand = cand
        self.rect_of = rect_of
        self.n_query_args = n_query_args
        self.z_depth = z_depth

    def __call__(self, parts, bounds, *q, axis=None):
        rects = self.rect_of(*q)
        overlap = Q.rect_overlaps_box(rects, bounds)
        ncand = overlap.sum(1, dtype=torch.int32)
        pids, valid, _ = _top_candidates(overlap, self.cand)
        local, mine = _local(pids, valid, axis, parts["count"].shape[0])
        width, total = Q.window_need_at(
            parts, bounds[pids], local, mine, rects, self.spec,
            z_depth=self.z_depth, **self.kw)
        return torch.stack([ncand, _pmax(width.amax(1), axis),
                            _psum(total.sum(1, dtype=torch.int32), axis)], 1)


class _KnnNeedLocal(_LocalFn):
    """The kNN need probe (DESIGN.md §13): for the J = 2 radii r0 * 2^j,
    per query [need, tot, nin]: the widest window demanded, the summed
    candidate mass, and the partitions within the radius. The executor
    predicts each row's resolving round from the first j whose mass
    reaches 2k; every kNN bucket still runs at the sticky tier, so the
    prediction moves cost, never values. Returns (Q, J, 3) int32."""

    n_query_args = 3
    J = 2

    def __init__(self, index, cfg, backend, cand):
        super().__init__(index, cfg, backend)
        self.cand = cand

    def __call__(self, parts, bounds, qx, qy, r0, axis=None):
        boxd2 = Q.box_min_dist2(qx, qy, bounds)             # (Q, P)
        # the cand nearest partitions, ties to the lowest index
        negd2, order = stable_topk(-boxd2, min(self.cand, boxd2.shape[1]))
        cand_d2 = -negd2
        boxes = bounds[order]
        local, inshard = _local(order, None, axis, parts["count"].shape[0])
        cols = []
        for j in range(self.J):
            r = r0 * float(2 ** j)
            rects = Q.circle_mbrs(qx, qy, r)
            rr = mul_f32(r, r)[:, None]
            active = cand_d2 <= rr
            if inshard is not None:
                active = active & inshard
            width, total = Q.window_need_at(
                parts, boxes, local, active, rects, self.spec, **self.kw)
            nin = (boxd2 <= rr).sum(1, dtype=torch.int32)
            cols.append(torch.stack([_pmax(width.amax(1), axis),
                                     _psum(total.sum(1, dtype=torch.int32),
                                           axis), nin], 1))
        return torch.stack(cols, 1)


def _select(pred, a, b):
    """``lax.cond``'s choice of one branch's output, made on the device:
    ``where(pred, a, b)`` leaf by leaf over equal tuples (or tensors),
    with ``pred`` a 0-dim bool tensor."""
    if isinstance(a, tuple):
        return tuple(torch.where(pred, u, v) for u, v in zip(a, b))
    return torch.where(pred, a, b)


class _KnnLadderLocal(_LocalFn):
    """On-device kNN escalation stage, the fused kNN program's fallback:
    the pruned rounds at the NEXT ladder cap, with the rows still
    unresolved there taken from the exact scan. A row's answer stays a
    function of the row alone: the escalated result if ok there, else
    the exact one. The reference's inner ``lax.cond`` is the same
    batch-wide select on the device as ``_CondFusedLocal``'s, so the
    exact scan runs on every call."""

    n_query_args = 3

    def __init__(self, index, cfg, backend, primary, exact):
        super().__init__(index, cfg, backend)
        self.primary = primary       # pruned rounds at the escalated cap
        self.exact = exact

    def __call__(self, parts, bounds, qx, qy, r0, axis=None):
        neg, vid, ok = self.primary(parts, bounds, qx, qy, r0, axis=axis)
        nege, vide = self.exact(parts, bounds, qx, qy, axis=axis)
        okc = ok[:, None]
        return _select(ok.all(), (neg, vid),
                       (torch.where(okc, neg, nege),
                        torch.where(okc, vid, vide)))


class _CondFusedLocal(_LocalFn):
    """Windowed primary + exact fallback in one program with no host
    read: the steady serving path (zero host syncs).

    The reference runs the fallback under ``lax.cond(all(ok), ...)``, so
    only the branch taken executes. Eager PyTorch has no conditional
    that avoids reading the predicate on the host, so this program runs
    the primary and then the fallback unconditionally, and picks the
    output on the device with the batch-wide ``all(ok)`` (a 0-dim
    tensor: ``lax.cond``'s predicate, not a per-row one). A clean call
    therefore pays for the fallback too; the fallback's kernels launch
    on every steady call.

    primary(parts, bounds, *q)              -> tuple containing ok
    fallback(parts, bounds, *q[fb_args])    -> exact result
    merge_ok(pri) / merge_fb(pri, fb)       -> the same output structure

    Returns (merged result, ok): the per-query ok flags ride along so the
    executor can stash them for Executor.maintain()'s deferred check."""

    def __init__(self, index, cfg, backend, primary, fallback, fb_args,
                 get_ok, merge_ok, merge_fb):
        super().__init__(index, cfg, backend)
        self.primary = primary
        self.fallback = fallback
        self.fb_args = fb_args
        self.get_ok = get_ok
        self.merge_ok = merge_ok
        self.merge_fb = merge_fb
        self.n_query_args = primary.n_query_args

    def __call__(self, parts, bounds, *q, axis=None):
        pri = self.primary(parts, bounds, *q, axis=axis)
        ok = self.get_ok(pri)
        fb = self.fallback(parts, bounds, *[q[i] for i in self.fb_args],
                           axis=axis)
        return _select(ok.all(), self.merge_ok(pri),
                       self.merge_fb(pri, fb)), ok
