"""Exact per-partition kNN top-k: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/knn_topk.py``
(``knn_topk``; wrapper ``kernels/ops.py:knn_topk``). Source:
``csrc/knn_topk.cu``. Bound: operations (a distance per query-point
pair; the points are shared by every query).

One launch covers a chunk of partitions. A block of 16 warps holds up
to 64 queries and one slice of a partition's points, copied into shared
memory once (``cp.async``). Each warp scans the slice in a scattered
order (the rows are in Morton order, which brings a query's neighbours
in a run of ever closer points, each a new entry) and keeps its
queries' k-lists in registers spread over its lanes, rejecting a point
with one compare against the list's k-th. The launcher splits the point
axis into as many slices as fill the card in one wave (``plan``: from
the kernel instance's occupancy, nq, the number of partitions and
``n_pad``; never from ``count``, which lies on the card), and the last
block of each (query block, partition) merges the slices' lists by
(d^2, position) in the same launch, so the result is the plain
version's bit for bit wherever the slice borders fall.

Bitwise notes: the distance is ``fma(dx, dx, dy*dy)``, XLA:CPU's
contraction; XLA:CPU reads float32 denormals as zero and flushes tiny
results, so ``dy*dy`` and the distance (which is also the value
returned) are flushed (``_num.dist2_f32``; ``dist2_ftz`` in the
kernel). The coordinates and their differences need no flush: they are
only squared. Two candidates at d^2 = 0 and 1e-40 are then a tie,
broken by the lower position, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch._num import dist2_f32, stable_topk
from repro_torch.kernels import _launches
from repro_torch.kernels._args import I, P, on_cpu, ptr, stream

launches = 0        # kernel launches (not plain-version calls)
MAX_K = 128         # largest k csrc/knn_topk.cu instantiates
NEG = -3.0e38       # empty slot value (as the reference's kernel)

_SIG = {"knn_topk_plan": [I, I, I, I, P],
        "knn_topk_launch": [P, P, P, P, P, I, I, I, I, I, I, I, I, P, P, P,
                            P, P, P, P]}


def knn_topk_plain(qx, qy, count, x, y, *, k: int):
    """(neg_d2 (C, Q, k) f32, idx (C, Q, k) int32) — each query's k
    nearest of each partition's first ``count`` points, nearest first,
    ties to the lowest position; empty slots hold (NEG, -1)."""
    n_pad = x.shape[1]
    dx = x[:, None, :] - qx[None, :, None]                 # (C, Q, n)
    dy = y[:, None, :] - qy[None, :, None]
    d2 = dist2_f32(dx, dy)                # XLA:CPU's contraction
    del dx, dy
    valid = torch.arange(n_pad, device=x.device)[None, :] < count[:, None]
    d2 = torch.where(valid[:, None, :], d2, torch.full(
        (), 3.0e38, dtype=torch.float32, device=x.device))
    kk = min(k, n_pad)
    neg, idx = stable_topk(-d2, kk)
    hit = -neg < 3.0e38
    neg = torch.where(hit, neg, torch.full((), NEG, dtype=torch.float32,
                                           device=x.device))
    idx = torch.where(hit, idx, -1).to(torch.int32)
    if kk < k:                            # fewer slots than k: pad
        pad = (0, k - kk)
        neg = torch.nn.functional.pad(neg, pad, value=NEG)
        idx = torch.nn.functional.pad(idx, pad, value=-1)
    return neg, idx


def knn_topk(qx, qy, count, x, y, *, k: int):
    """Per-partition top-k nearest points of each query.

    qx, qy (Q,) f32; count (C,) int32; x, y (C, n_pad) f32. Returns
    (neg_d2 (C, Q, k) f32, idx (C, Q, k) int32 positions in the row).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    args = (qx, qy, count, x, y)
    if on_cpu(*args):
        return knn_topk_plain(*args, k=k)
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside (0, {MAX_K}]")
    c, n_pad = x.shape
    nq = qx.shape[0]
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(qx, "qx", f32, (nq,)), ptr(qy, "qy", f32, (nq,)),
            ptr(count, "count", i32, (c,)), ptr(x, "x", f32, (c, n_pad)),
            ptr(y, "y", f32, (c, n_pad))]
    neg = torch.empty((c, nq, k), dtype=f32, device=x.device)
    idx = torch.empty((c, nq, k), dtype=i32, device=x.device)
    if nq == 0 or c == 0:
        return neg, idx
    from repro_torch.kernels import _build
    lib = _build.load("knn_topk", _SIG)
    qw, qblocks, slices, slice_len = plan(nq, n_pad, c, k, x.device)
    part_d = torch.empty((c, nq, slices, k), dtype=f32, device=x.device)
    part_p = torch.empty((c, nq, slices, k), dtype=i32, device=x.device)
    # the least published k-th per (partition, query), encoded, and the
    # finished slices per (partition, query block): both from zero
    zeros = torch.zeros(c * (nq + qblocks), dtype=i32, device=x.device)
    err = lib.knn_topk_launch(
        *ptrs, nq, n_pad, c, k, qw, qblocks, slices, slice_len,
        ptr(part_d, "part_d", f32, part_d.shape),
        ptr(part_p, "part_p", i32, part_p.shape),
        ctypes.c_void_p(zeros.data_ptr()),
        ctypes.c_void_p(zeros.data_ptr() + 4 * c * nq),
        ptr(neg, "neg", f32, (c, nq, k)), ptr(idx, "idx", i32, (c, nq, k)),
        stream())
    _build.check(lib, "knn_topk", err)
    _launches.count(__name__)
    return neg, idx


def plan(nq: int, n_pad: int, n_parts: int, k: int, device) -> tuple:
    """The kernel's launch plan on a CUDA ``device``: (queries per warp,
    query blocks, slices per partition, points per slice). The slices
    are as many as keep one launch's blocks resident at once, with
    4,096 to 12,288 points each. Host arithmetic and an occupancy query
    only (no device read); computed anew on every call."""
    from repro_torch.kernels import _build
    lib = _build.load("knn_topk", _SIG)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device(device)):
        err = lib.knn_topk_plan(nq, n_pad, n_parts, k,
                                ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, "knn_topk_plan", err)
    return tuple(out)
