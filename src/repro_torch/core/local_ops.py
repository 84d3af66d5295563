"""Local query programs, single device (paper §3-4).

Each class is a program ``fn(parts, bounds, *query_args)`` with
attribute ``n_query_args``. ``parts`` is the dict of (P, ...) partition
tensors, ``bounds`` the (P, 4) partition boxes (the global index).

Every program is staged lookup -> scan -> merge: lookup and scan come
from the backend (core/backends.py: plain PyTorch or the CUDA kernels),
the merge (a sum of counts, an OR of flags, a top-k merge) stays here.
Partition-sweep programs walk the partitions in chunks of
``cfg.part_chunk``; the backend takes a whole chunk per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.core import queries as Q
from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.plan import EngineConfig

EMPTY_BOX = np.asarray([3e38, 3e38, -3e38, -3e38], np.float32)


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
        max_run=None if index.max_run is None else pad(index.max_run, 0),
        # the true overflow grid keeps its pre-padding position
        overflow_pid=index.overflow,
    )


def part_arrays(index: LearnedSpatialIndex) -> dict:
    """Dict-of-tensors view of the index (leading axis = partitions)."""
    return {
        "keys_f": K.keys_to_f32(index.key),
        "x": index.x, "y": index.y, "vid": index.vid, "count": index.count,
        "knot_keys": index.knot_keys, "knot_pos": index.knot_pos,
        "n_knots": index.n_knots, "radix_table": index.radix_table,
        "radix_kmin": index.radix_kmin, "radix_scale": index.radix_scale,
    }


def _chunks(parts: dict, chunk: int):
    """Yield (first partition, chunk dict) over consecutive partition
    chunks; every chunk leaf is a contiguous (C, ...) slice."""
    p = parts["count"].shape[0]
    c = min(chunk, p)
    if p % c:
        raise ValueError(f"{p} partitions do not split into chunks of {c}")
    for lo in range(0, p, c):
        yield lo, {k: v[lo:lo + c] for k, v in parts.items()}


class _LocalFn:
    def __init__(self, index: LearnedSpatialIndex, cfg: EngineConfig,
                 backend):
        self.kw = dict(radix_bits=index.radix_bits, probe=index.probe)
        self.cfg = cfg
        self.backend = backend
        self.n_pad = index.n_pad
        self.overflow = index.overflow


class _PointLocal(_LocalFn):
    """Point probe, query-centric: each query touches only its
    first-match grid partition and the overflow grid (paper Alg. 1).
    Lookup: ``Q.lower_bound_at`` per query; scan: the backend's
    point_scan over the probe window (one launch per candidate set)."""

    n_query_args = 3

    def candidates(self, bounds, qx, qy):
        """(Q,) first matching grid partition of each point (the overflow
        grid when none matches), and (Q,) the overflow grid."""
        ov = self.overflow
        inb = Q.point_in_box(qx, qy, bounds[:ov])                 # (Q, G)
        col = torch.arange(inb.shape[1], device=qx.device)
        cand = torch.where(inb, col, ov)
        pid1 = torch.cat([cand, torch.full_like(cand[:, :1], ov)], 1).amin(1)
        return pid1, torch.full_like(pid1, ov)

    def window_starts(self, parts, pid, qk):
        """(Q,) probe-window start around each key's learned position in
        its partition ``pid`` (the lookup stage)."""
        probe = self.kw["probe"]
        pos = Q.lower_bound_at(parts, pid, qk, probe=probe)
        return torch.clamp(pos - probe // 2, 0, self.n_pad - probe)

    def __call__(self, parts, bounds, qx, qy, qk):
        found = None
        for pid in self.candidates(bounds, qx, qy):
            start = self.window_starts(parts, pid, qk)            # lookup
            hit = self.backend.point_scan(parts, pid, start, qk, qx, qy,
                                          probe=self.kw["probe"])  # scan
            found = hit if found is None else found | hit          # merge
        return found.to(torch.int32)


class _RangeCountLocal(_LocalFn):
    """Exact range count: every chunk's learned [s, e) bounds, then the
    masked in-rect count; a (query, partition) pair whose boxes do not
    overlap is inactive and counts 0."""

    n_query_args = 3

    def __call__(self, parts, bounds, rects, klo, khi):
        bk = self.backend
        overlap = Q.rect_overlaps_box(rects, bounds)          # (Q, P)
        acc = torch.zeros(rects.shape[0], dtype=torch.int32,
                          device=rects.device)
        for lo, ch in _chunks(parts, self.cfg.part_chunk):
            c = ch["count"].shape[0]
            act = overlap[:, lo:lo + c].t().contiguous()      # (C, Q)
            s, e = bk.bounds(ch, klo, khi, **self.kw)         # lookup
            cnt = bk.range_scan(ch, rects, s, e, active=act)  # scan
            acc += cnt.sum(0, dtype=torch.int32)              # merge
        return acc


class _KnnExactLocal(_LocalFn):
    """Exact kNN over every partition: per-chunk candidates from the
    backend, streamed into a running top-k (ties to the lowest index,
    carry first, so the result equals one top-k over all points in
    partition order)."""

    n_query_args = 2

    def __init__(self, index, cfg, backend, k):
        super().__init__(index, cfg, backend)
        self.k = k

    def __call__(self, parts, bounds, qx, qy):
        qn, k = qx.shape[0], self.k
        bk = self.backend
        neg = torch.full((qn, k), -3e38, dtype=torch.float32,
                         device=qx.device)
        vid = torch.full((qn, k), -1, dtype=torch.int32, device=qx.device)
        for _, ch in _chunks(parts, self.cfg.part_chunk):
            cn, cv = bk.knn_scan(ch, qx, qy, k)               # (C, Q, W)
            cn = cn.transpose(0, 1).reshape(qn, -1)
            cv = cv.transpose(0, 1).reshape(qn, -1)
            neg, vid = bk.topk_merge(neg, vid, cn, cv, k)     # merge
        return neg, vid
