"""Batched index mutations: insert and delete absorption, and the
per-partition spline re-fit (the paper's update story; DESIGN.md §11).

The mutable-index contract (``build.LearnedSpatialIndex``):

  insert   append to the target partition's DELTA BUFFER (capacity-
           padded slots; the host grows the capacity when a batch would
           overflow it, a static-shape change that bumps
           ``shape_epoch``).
  delete   tombstone in place: the sorted key row is untouched (the
           fitted spline stays valid), the coordinates become
           ``PAD_COORD`` and the vid -1, so every coordinate-refine
           scan, plain or kernel, excludes the slot with no extra mask.
           Deletes of still-buffered inserts poison the delta slot the
           same way.
  refit    ``refit_partitions(idx, touched)``: merge the delta, drop
           tombstones and re-run the error-bounded spline fit (the
           build's host fit, ``build.fit_partitions``) over ONLY the
           touched partition rows; untouched partitions keep their
           tensors bit for bit. After a full re-fit the index answers
           every query bitwise like a fresh ``build_index`` of the
           surviving points (tests/test_torch_updates.py).

All entry points are host-driven, like ``build_index``: they may read
the host (capacity checks, the re-fit), never on the query path.

Bitwise notes: a delete compares coordinates with float32 denormals
read as zero, as XLA:CPU compares them (a point at (1e-45, 0.5) is
removed by a delete of (0.0, 0.5)); keys are int64 (torch's uint32 has
no shifts, compares or sort), and the merge's stable sort of them with
the sentinel gives the reference's layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._num import flush_denormals
from repro_torch.core import keys as K
from repro_torch.core.build import (PAD_COORD, LearnedSpatialIndex,
                                    assign_partitions, fit_partitions,
                                    probe_for)

# elements of one (rows, n_pad) candidate-row plane of a delete
DELETE_CHUNK_ELEMS = 1 << 26


def _pow2_at_least(n: int, floor: int) -> int:
    if max(n, floor) <= 0:
        return 0        # zero-capacity request: bookkeeping only
    return max(floor, int(2 ** np.ceil(np.log2(max(n, 1)))))


def row_max_runs(key_g: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(P,) int32 longest duplicate-key run per row (valid prefix only):
    the probe-sizing statistic, for an index that lacks ``max_run``."""
    p, n_pad = key_g.shape
    keys_f = K.keys_to_f32(key_g)
    idx = torch.arange(n_pad, dtype=torch.int32, device=key_g.device)
    valid = idx[None, :] < counts[:, None]
    prev = torch.cat([torch.full((p, 1), -1.0, dtype=torch.float32,
                                 device=key_g.device), keys_f[:, :-1]], 1)
    first = valid & (keys_f != prev)
    start = torch.where(first, idx[None, :], -1)
    last_start = torch.cummax(start, dim=1).values
    runlen = torch.where(valid, idx[None, :] - last_start + 1, 0)
    return runlen.amax(1).to(torch.int32)


def with_delta_capacity(index: LearnedSpatialIndex, cap: int,
                        floor: int = 64) -> LearnedSpatialIndex:
    """Grow the per-partition delta buffer to hold >= ``cap`` slots.

    Returns the index unchanged when it already fits; otherwise pads the
    delta planes to the next power of two (at least ``floor``) and bumps
    ``shape_epoch``."""
    if index.delta_key is not None and index.delta_cap >= cap:
        return index
    new_cap = _pow2_at_least(cap, floor)
    p = index.num_partitions
    dev = index.device

    def grow(a, fill, dtype):
        fresh = torch.full((p, new_cap), fill, dtype=dtype, device=dev)
        if a is not None and a.shape[1]:
            fresh[:, :a.shape[1]] = a
        return fresh

    def zeros(a):
        return (a if a is not None
                else torch.zeros((p,), dtype=torch.int32, device=dev))

    return dataclasses.replace(
        index,
        delta_key=grow(index.delta_key, index.key_spec.sentinel,
                       torch.int64),
        delta_x=grow(index.delta_x, PAD_COORD, torch.float32),
        delta_y=grow(index.delta_y, PAD_COORD, torch.float32),
        delta_vid=grow(index.delta_vid, -1, torch.int32),
        delta_count=zeros(index.delta_count),
        dead=zeros(index.dead),
        max_run=(index.max_run if index.max_run is not None
                 else row_max_runs(index.key, index.count)),
        refit_gen=zeros(index.refit_gen),
        shape_epoch=index.shape_epoch + 1,
    )


def shrink_delta_capacity(index: LearnedSpatialIndex,
                          cap: int) -> LearnedSpatialIndex:
    """Slice burst-grown delta planes back down after compaction has
    emptied them (the inverse of ``with_delta_capacity``). The caller
    must have re-fit first: every buffered entry must fit."""
    new_cap = _pow2_at_least(cap, 0)
    if new_cap >= index.delta_cap:
        return index
    if int(index.delta_count.max()) > new_cap:
        raise ValueError("shrink below live delta occupancy")
    return dataclasses.replace(
        index,
        delta_key=index.delta_key[:, :new_cap].contiguous(),
        delta_x=index.delta_x[:, :new_cap].contiguous(),
        delta_y=index.delta_y[:, :new_cap].contiguous(),
        delta_vid=index.delta_vid[:, :new_cap].contiguous(),
        shape_epoch=index.shape_epoch + 1,
    )


def assign_insert(index: LearnedSpatialIndex, xs, ys) -> torch.Tensor:
    """(B,) int64 partition ids of new points: the first grid box holding
    each (flushed compares, as the build's), misses to the overflow grid
    (``assign_partitions`` returns the grid size, the overflow id)."""
    return assign_partitions(xs, ys, index.part_bounds[:index.overflow])


# ---------------------------------------------------------------------------
# mutation steps (device tensors; shapes fixed per batch and capacity)
# ---------------------------------------------------------------------------

def scatter_inserts(dkey, dx, dy, dvid, dcount, pid, key, xs, ys, vids):
    """Append a batch into the delta planes; the caller guarantees the
    capacity. Returns the new (dkey, dx, dy, dvid, dcount).

    Each insert's slot is its partition's count plus its rank among the
    batch's earlier inserts to that partition: arrival (= vid) order, so
    a later stable merge gives the fresh build's tie order. The rank is
    the reference's O(B^2) same-partition mask summed below the
    diagonal, computed here as a position in the stable sort by
    partition (the same integers, in O(B log B))."""
    b = pid.shape[0]
    pid = pid.to(torch.int64)
    order = torch.sort(pid, stable=True).indices
    sp = pid[order].contiguous()
    rank = torch.empty_like(pid)
    rank[order] = (torch.arange(b, device=pid.device) -
                   torch.searchsorted(sp, sp))
    slot = dcount[pid].to(torch.int64) + rank

    def put(plane, values):
        out = plane.clone()
        out[pid, slot] = values.to(plane.dtype)
        return out

    dc = dcount.clone()
    dc.index_add_(0, pid, torch.ones_like(pid, dtype=dcount.dtype))
    return (put(dkey, key), put(dx, xs), put(dy, ys), put(dvid, vids), dc)


def _hits(xp, yp, vidp, count, qx2, qy2, pids) -> torch.Tensor:
    """(P, W) bool: the slots of the candidate rows ``pids`` (2B,) that
    hold a live copy of their query (qx2, qy2), coordinates compared
    with denormals read as zero. The reference's ``.at[pids].max`` over
    repeated partition ids is an OR; here a scatter-add of 0/1 flags
    tested > 0, the candidate rows taken in chunks of at most
    ``DELETE_CHUNK_ELEMS`` elements (an OR of chunks is the OR)."""
    p, w = xp.shape
    fx, fy = flush_denormals(xp), flush_denormals(yp)
    qx2, qy2 = flush_denormals(qx2), flush_denormals(qy2)
    posn = torch.arange(w, dtype=torch.int32, device=xp.device)
    hit = torch.zeros((p, w), dtype=torch.int32, device=xp.device)
    rows = max(1, DELETE_CHUNK_ELEMS // max(w, 1))
    for i in range(0, pids.shape[0], rows):
        pc = pids[i:i + rows]
        m = ((fx[pc] == qx2[i:i + rows, None]) &
             (fy[pc] == qy2[i:i + rows, None]) & (vidp[pc] >= 0) &
             (posn[None, :] < count[pc][:, None]))
        hit.index_add_(0, pc, m.to(torch.int32))
    return hit > 0


def apply_deletes(xp, yp, vidp, count, dxp, dyp, dvidp, dcount, dead,
                  qx, qy, pid1, pid2, mine=None):
    """Tombstone every live copy of each (x, y) in its two candidate
    partitions (the first-match grid box and the overflow grid), main
    plane AND delta.

    ``mine`` (B, 2) bool, on a meshed rank: which of each row's two
    candidates (given as this shard's rows) the shard holds; the others
    match nothing (their coordinates become NaN, which equals nothing).

    Returns the poisoned planes (x, y, vid, dx, dy, dvid), the updated
    per-partition dead count and the number of removed points (a 0-dim
    int32 tensor)."""
    pids = torch.stack([pid1, pid2], 1).reshape(-1)          # (2B,)
    qx2 = torch.repeat_interleave(qx, 2)
    qy2 = torch.repeat_interleave(qy, 2)
    if mine is not None:
        mine = mine.reshape(-1)
        qx2 = torch.where(mine, qx2, float("nan"))
        qy2 = torch.where(mine, qy2, float("nan"))

    hit = _hits(xp, yp, vidp, count, qx2, qy2, pids)
    newly = hit & (vidp >= 0)
    new_x = torch.where(hit, PAD_COORD, xp)
    new_y = torch.where(hit, PAD_COORD, yp)
    new_v = torch.where(hit, -1, vidp)
    dead2 = dead + newly.sum(1, dtype=torch.int32)
    removed = newly.sum(dtype=torch.int32)

    if dxp.shape[1]:
        dhit = _hits(dxp, dyp, dvidp, dcount, qx2, qy2, pids)
        dnew = dhit & (dvidp >= 0)
        dxp = torch.where(dhit, PAD_COORD, dxp)
        dyp = torch.where(dhit, PAD_COORD, dyp)
        dvidp = torch.where(dhit, -1, dvidp)
        removed = removed + dnew.sum(dtype=torch.int32)

    return new_x, new_y, new_v, dxp, dyp, dvidp, dead2, removed


def merge_rows(key_r, x_r, y_r, vid_r, count_r, dkey_r, dx_r, dy_r, dvid_r,
               dcount_r, *, sentinel: int):
    """Compact k gathered partition rows: drop tombstones, merge delta.

    A stable sort over (main row ++ delta row) keys, tombstones and
    padding mapped to the sentinel so they sink to the tail, yields rows
    sorted by (key asc, vid asc): the main row already holds equal keys
    in vid order and delta vids are strictly newer, so stability
    reproduces the fresh build's layout bit for bit. Returns (key, x, y,
    vid (k, n_pad), count (k,) int32)."""
    n_pad = key_r.shape[1]
    posn = torch.arange(n_pad, dtype=torch.int32, device=key_r.device)
    alive_m = (vid_r >= 0) & (posn[None, :] < count_r[:, None])
    keyc = torch.where(alive_m, key_r, sentinel)
    xc = torch.where(alive_m, x_r, PAD_COORD)
    yc = torch.where(alive_m, y_r, PAD_COORD)
    vc = torch.where(alive_m, vid_r, -1)
    n_alive = alive_m.sum(1, dtype=torch.int32)

    d_cap = dkey_r.shape[1]
    if d_cap:
        slot = torch.arange(d_cap, dtype=torch.int32, device=key_r.device)
        alive_d = (dvid_r >= 0) & (slot[None, :] < dcount_r[:, None])
        keyc = torch.cat([keyc, torch.where(alive_d, dkey_r, sentinel)], 1)
        xc = torch.cat([xc, torch.where(alive_d, dx_r, PAD_COORD)], 1)
        yc = torch.cat([yc, torch.where(alive_d, dy_r, PAD_COORD)], 1)
        vc = torch.cat([vc, torch.where(alive_d, dvid_r, -1)], 1)
        n_alive = n_alive + alive_d.sum(1, dtype=torch.int32)

    order = torch.sort(keyc, dim=1, stable=True).indices[:, :n_pad]
    return (torch.gather(keyc, 1, order), torch.gather(xc, 1, order),
            torch.gather(yc, 1, order), torch.gather(vc, 1, order), n_alive)


# ---------------------------------------------------------------------------
# per-partition re-fit (host entry point, like build_index)
# ---------------------------------------------------------------------------

def grow_n_pad(index: LearnedSpatialIndex,
               new_n_pad: int) -> LearnedSpatialIndex:
    """Widen the data plane to ``new_n_pad`` rounded up to a multiple of
    128 (rare: merged rows outgrew n_pad)."""
    new_n_pad = int(np.ceil(new_n_pad / 128) * 128)
    if new_n_pad <= index.n_pad:
        return index
    p = index.num_partitions
    extra = new_n_pad - index.n_pad

    def widen(a, fill):
        pad = torch.full((p, extra), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], 1)

    return dataclasses.replace(
        index,
        key=widen(index.key, index.key_spec.sentinel),
        x=widen(index.x, PAD_COORD), y=widen(index.y, PAD_COORD),
        vid=widen(index.vid, -1),
        shape_epoch=index.shape_epoch + 1,
    )


def dirty_partitions(index: LearnedSpatialIndex) -> np.ndarray:
    """Partition ids with buffered inserts or tombstones (host view)."""
    if index.delta_count is None:
        return np.zeros((0,), np.int32)
    dirty = index.delta_count.cpu().numpy() > 0
    if index.dead is not None:
        dirty |= index.dead.cpu().numpy() > 0
    return np.nonzero(dirty)[0].astype(np.int32)


def delta_occupancy(index: LearnedSpatialIndex) -> np.ndarray:
    """Per-partition dirtiness, (buffered + tombstoned) over live points:
    the executor's compaction trigger (host view, float64)."""
    p = index.num_partitions
    if index.delta_count is None:
        return np.zeros((p,), np.float64)
    dcount = index.delta_count.cpu().numpy().astype(np.int64)
    dead = (index.dead.cpu().numpy().astype(np.int64)
            if index.dead is not None else np.zeros((p,), np.int64))
    count = index.count.cpu().numpy().astype(np.int64)
    live = np.maximum(count - dead + dcount, 1)
    return (dcount + dead) / live


def refit_partitions(index: LearnedSpatialIndex, touched, agree=None
                     ) -> LearnedSpatialIndex:
    """Merge the delta, drop tombstones and re-fit the spline of ONLY the
    ``touched`` partitions. Bumps ``epoch`` and the touched rows'
    ``refit_gen``; untouched partitions keep their tensors bit for bit.

    Capacity growth (n_pad, knot width, probe) happens here when the
    merged rows outgrow the current statics, each bumping
    ``shape_epoch``.

    ``agree`` (int -> int, the maximum over a meshed executor's shards)
    makes each of the three statics the one the whole index needs, on
    every shard, before it is installed; a shard then runs every step,
    even with no touched row of its own, so the collectives meet."""
    touched = np.unique(np.asarray(touched, np.int32))
    if touched.size == 0 and agree is None:
        return index
    agree = agree or (lambda v: v)
    if index.delta_key is None:
        index = with_delta_capacity(index, 0, floor=0)
    dev = index.device
    t = torch.as_tensor(touched.astype(np.int64), device=dev)

    # -- host sizing: merged rows must fit the data plane --------------
    dead = index.dead.cpu().numpy()
    alive_delta = (index.delta_vid >= 0).sum(1, dtype=torch.int32)
    new_counts = (index.count.cpu().numpy() - dead +
                  alive_delta.cpu().numpy())[touched]
    need = agree(int(new_counts.max(initial=0)))
    if need > index.n_pad:
        index = grow_n_pad(index, need)

    key_r, x_r, y_r, vid_r, cnt = merge_rows(
        index.key[t], index.x[t], index.y[t], index.vid[t], index.count[t],
        index.delta_key[t], index.delta_x[t], index.delta_y[t],
        index.delta_vid[t], index.delta_count[t],
        sentinel=index.key_spec.sentinel)

    # -- re-fit: the build's host fit, doubling the knot width on need --
    key_np, cnt_np = key_r.cpu().numpy(), cnt.cpu().numpy()
    m = index.knot_keys.shape[1]

    def fit_at(m_pad):
        return fit_partitions(key_np, cnt_np, eps=index.eps, m_pad=m_pad,
                              radix_bits=index.radix_bits)

    while True:
        fit = fit_at(m) if touched.size else None
        if fit is None or not fit["overflow"].any():
            break
        if m >= index.n_pad:
            raise RuntimeError("spline knot capacity exceeded at n_pad")
        m = min(m * 2, index.n_pad)
    m_all = agree(m)
    if m_all != m:          # another shard's rows need the wider row
        m = m_all
        fit = fit_at(m) if touched.size else None
    if m != index.knot_keys.shape[1]:
        extra = m - index.knot_keys.shape[1]
        p = index.num_partitions
        index = dataclasses.replace(
            index,
            knot_keys=torch.cat([index.knot_keys, torch.full(
                (p, extra), 3.4e38, dtype=torch.float32, device=dev)], 1),
            knot_pos=torch.cat([index.knot_pos, torch.zeros(
                (p, extra), dtype=torch.float32, device=dev)], 1),
            shape_epoch=index.shape_epoch + 1)

    # -- scatter the compacted rows and the fresh fit back --------------
    def put(a, v):
        """``a`` with rows ``t`` set to ``v`` (rows, or one fill value)."""
        out = a.clone()
        if v is None:           # no touched row here
            return out
        if isinstance(v, np.ndarray):
            v = torch.as_tensor(np.ascontiguousarray(v), device=dev)
        out[t] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
        return out

    gen = index.refit_gen.clone()
    gen[t] += 1
    if fit is None:
        fit = dict.fromkeys(("knot_keys", "knot_pos", "n_knots",
                             "radix_table", "radix_kmin", "radix_scale",
                             "max_run"))
    new = dataclasses.replace(
        index,
        key=put(index.key, key_r), x=put(index.x, x_r), y=put(index.y, y_r),
        vid=put(index.vid, vid_r), count=put(index.count, cnt),
        knot_keys=put(index.knot_keys, fit["knot_keys"]),
        knot_pos=put(index.knot_pos, fit["knot_pos"]),
        n_knots=put(index.n_knots, fit["n_knots"]),
        radix_table=put(index.radix_table, fit["radix_table"]),
        radix_kmin=put(index.radix_kmin, fit["radix_kmin"]),
        radix_scale=put(index.radix_scale, fit["radix_scale"]),
        delta_key=put(index.delta_key, index.key_spec.sentinel),
        delta_x=put(index.delta_x, PAD_COORD),
        delta_y=put(index.delta_y, PAD_COORD),
        delta_vid=put(index.delta_vid, -1),
        delta_count=put(index.delta_count, 0), dead=put(index.dead, 0),
        max_run=(put(index.max_run, fit["max_run"])
                 if index.max_run is not None else None),
        refit_gen=gen,
        epoch=index.epoch + 1,
    )

    # -- probe refresh: duplicate runs may have grown -------------------
    # the build's sizing rule over the GLOBAL max run, so a fully re-fit
    # index carries the probe a fresh build of the surviving points would
    if new.max_run is not None:
        # probe_for grows with the run: the shards' maximum is the
        # probe of the whole index's longest run
        need = agree(probe_for(new.eps, int(new.max_run.max()), new.n_pad))
        if need > new.probe:
            new = dataclasses.replace(new, probe=need,
                                      shape_epoch=new.shape_epoch + 1)
    return new


def _spline_predict(knot_keys, knot_pos, n_knots, q) -> np.ndarray:
    """Interpolated first-occurrence rank of float32 keys ``q`` (host,
    float32, the reference's eager ``spline.spline_predict``)."""
    seg = np.searchsorted(knot_keys, q, side="right") - 1
    seg = np.clip(seg, 0, max(int(n_knots) - 2, 0))
    k0, k1 = knot_keys[seg], knot_keys[seg + 1]
    p0, p1 = knot_pos[seg], knot_pos[seg + 1]
    t = (q - k0) / np.maximum(k1 - k0, np.float32(1e-30))
    t = np.clip(t, np.float32(0.0), np.float32(1.0))
    return p0 + t * (p1 - p0)


def verify_eps(index: LearnedSpatialIndex, pid: int) -> float:
    """Max |S(key) - first_occurrence_rank| over one partition's keys.

    The greedy corridor guarantees <= 2*eps at interpolation (a corridor
    restart anchors at the previous data point, itself up to eps off the
    fitted line; a fresh build shows the same bound). A host diagnostic:
    the tests re-check it per touched partition after every re-fit."""
    cnt = int(index.count[pid])
    if cnt == 0:
        return 0.0
    keys_f = K.keys_to_f32(index.key[pid, :cnt]).cpu().numpy()
    first = np.concatenate([[True], keys_f[1:] != keys_f[:-1]])
    pred = _spline_predict(index.knot_keys[pid].cpu().numpy(),
                           index.knot_pos[pid].cpu().numpy(),
                           index.n_knots[pid].cpu().numpy(), keys_f)
    pos = np.arange(cnt, dtype=np.float32)
    return float(np.max(np.abs(pred[first] - pos[first])))
