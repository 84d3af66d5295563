"""On the card: each CUDA kernel against its plain version, and the
engine's cuda backend against its torch backend and the golden fixture.

This file imports neither jax nor the JAX package, so it runs where only
the port is installed. Every test carries the ``gpu`` marker and skips
where there is no card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import gc
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import core as T
from repro_torch import kernels as KERN
from repro_torch.core import EngineConfig, SpatialEngine, build_index, fit
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.data import spatial as ds
from repro_torch.kernels import circle_filter as t_cf
from repro_torch.kernels import knn_topk as t_knn
from repro_torch.kernels import morton as t_mo
from repro_torch.kernels import point_in_polygon as t_pip
from repro_torch.kernels import point_probe as t_pp
from repro_torch.kernels import range_filter as t_rf
from repro_torch.kernels import spline_search as t_ss
from repro_torch.serve import SpatialServeSession

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "spatial_golden.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index():
    """A port index with duplicate points (ties, long key runs),
    partitions below n_pad, and two empty padding partitions (CPU)."""
    x, y = ds.make("taxi", 5000, seed=3)
    dup = np.random.default_rng(0).integers(0, 5000, 600)
    x = np.concatenate([x, x[dup]])
    y = np.concatenate([y, y[dup]])
    idx = build_index(x, y, fit("kdtree", x, y, 6, seed=0), device="cpu")
    return x, y, L.pad_partitions(idx, 8)


def _on(dev, *arrays):
    return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]


def _query_keys(idx, rng, nq):
    kf = K.keys_to_f32(idx.key).numpy()
    cnt = idx.count.numpy()
    sent = float(idx.key_spec.sentinel)
    data = kf[0, rng.integers(0, cnt[0], nq // 2)]
    rand = rng.integers(0, 1 << 22, nq - nq // 2 - 6).astype(np.float32)
    edge = np.asarray([0, 1, sent - 1, sent, sent + 1, kf[1, cnt[1] - 1]],
                      np.float32)
    return np.concatenate([data, rand, edge]).astype(np.float32)


def test_gpu_spline_search_matches_plain(index, cuda):
    _, _, idx = index
    q = _query_keys(idx, np.random.default_rng(1), 1000)
    args = _on(cuda, q, idx.knot_keys, idx.knot_pos, idx.radix_table,
               K.keys_to_f32(idx.key), idx.radix_kmin, idx.radix_scale,
               idx.n_knots, idx.count)
    kw = dict(probe=idx.probe, radix_bits=idx.radix_bits)
    n0 = t_ss.launches
    got = t_ss.spline_search(*args, **kw)
    assert t_ss.launches == n0 + 1
    assert torch.equal(got, t_ss.spline_search_plain(*args, **kw))


def test_gpu_spline_search_wide_knot_row(cuda):
    """A wide knot row (eps 0 on distinct random keys: about 60 knots
    per radix bucket) takes the kernel's strided segment locate, whose
    knot windows pass the lane group's width."""
    from repro_torch.core.build import fit_partitions

    rng = np.random.default_rng(3)
    n = 61440
    keys = np.sort(rng.choice(1 << 22, n, replace=False))[None, :]
    count = np.asarray([n], np.int32)
    fit = fit_partitions(keys, count, eps=0, m_pad=n, radix_bits=10)
    assert (2 * n + 1026) * 4 > 200 * 1024 and fit["n_knots"][0] > 1000
    keys_f = keys.astype(np.float32)
    q = np.concatenate([keys_f[0, ::7], rng.integers(
        0, 1 << 22, 3000).astype(np.float32)])
    args = _on(cuda, q, fit["knot_keys"], fit["knot_pos"],
               fit["radix_table"], keys_f, fit["radix_kmin"],
               fit["radix_scale"], fit["n_knots"], count)
    kw = dict(probe=64, radix_bits=10)
    got = t_ss.spline_search(*args, **kw)
    assert torch.equal(got, t_ss.spline_search_plain(*args, **kw))
    want = np.searchsorted(keys_f[0], q).astype(np.int32)
    assert np.array_equal(got[0].cpu().numpy(), want)


@pytest.mark.parametrize("run", [40, 400])
def test_gpu_spline_search_edge_keys(cuda, run):
    """Keys beyond every valid key, below kmin and at long runs of
    duplicate keys, over rows that are full (the window start clamped at
    n_pad - probe), part full, and empty, each bitwise against the plain
    version and numpy's searchsorted capped at the count. The runs set
    the probe: 256 keys (the reference index's, one key per sample of
    the two-level count) and 1,024 (64 keys per sample)."""
    from repro_torch.core.build import fit_partitions, probe_for

    rng = np.random.default_rng(4)
    n_pad, eps = 5000, 32
    counts = np.asarray([n_pad, 3100, 4000, 0], np.int32)
    keys = np.full((4, n_pad), (1 << 32) - 1, np.int64)
    for c, n in enumerate(counts):
        row = np.sort(rng.integers(1000, 1 << 22, n))
        if c == 1:
            row[500:500 + run] = row[500]     # a run of equal keys
            row[n - run:] = row[n - run]      # the row ends in a run
        keys[c, :n] = np.sort(row)
    fit = fit_partitions(keys, counts, eps=eps, m_pad=512, radix_bits=10)
    probe = probe_for(eps, int(fit["max_run"].max()), n_pad)
    assert probe == {40: 256, 400: 1024}[run]
    valid = np.arange(n_pad)[None, :] < counts[:, None]
    keys_f = np.where(valid, keys.astype(np.float32), np.float32(3.0e38))
    n1 = counts[1]
    q = np.concatenate([
        keys_f[0, rng.integers(0, n_pad, 300)],
        keys_f[1, [499, 500, 500 + run // 2, 500 + run - 1, 500 + run,
                   n1 - run - 1, n1 - run, n1 - 1]],
        keys_f[2, ::37],
        rng.integers(0, 1 << 22, 300).astype(np.float32),
        [0.0, 1.0, 999.0, -1.0, -np.inf,                     # below kmin
         float(1 << 22), float(1 << 24), float(1 << 31), 3.0e38,
         np.inf]]).astype(np.float32)                        # beyond
    args = _on(cuda, q, fit["knot_keys"], fit["knot_pos"],
               fit["radix_table"], keys_f, fit["radix_kmin"],
               fit["radix_scale"], fit["n_knots"], counts)
    kw = dict(probe=probe, radix_bits=10)
    got = t_ss.spline_search(*args, **kw)
    assert torch.equal(got, t_ss.spline_search_plain(*args, **kw))
    # inside the key space (keys below 2^32) the search is searchsorted
    # capped at the count; past it (3e38, inf) the last segment runs to
    # the knot row's 3.4e38 padding, and the kernel is held to the plain
    # version (the reference's arithmetic) alone
    got = got.cpu().numpy()
    keyspace = q < 2.0 ** 32
    for c, n in enumerate(counts):
        want = np.minimum(np.searchsorted(keys_f[c, :n], q), n)
        assert np.array_equal(got[c, keyspace], want[keyspace]), c
    assert (got[0, -5:-2] == n_pad).all()    # window start clamped
    assert (got[3] == 0).all()


def test_gpu_range_count_matches_plain(index, cuda):
    _, _, idx = index
    rng = np.random.default_rng(5)
    nq, (c, n_pad) = 300, idx.x.shape
    rects = ds.random_rects(nq, 3e-2, (0, 0, 1, 1), seed=5)
    s = rng.integers(0, n_pad, (c, nq)).astype(np.int32)
    e = (s + rng.integers(-50, n_pad, (c, nq))).astype(np.int32)
    s[:, 0], e[:, 0] = 0, n_pad                 # the whole row
    e = np.minimum(e, n_pad + 64)               # e may pass n_pad
    active = rng.random((c, nq)) < 0.7
    args = _on(cuda, rects, s, e, active, idx.count, idx.x, idx.y)
    got = t_rf.range_count(*args)
    assert int(got.sum()) > 0
    assert torch.equal(got, t_rf.range_count_plain(*args))


# the interval sets both count kernels are held to, here and (against
# a mirror of csrc/interval_scan.cuh's split) in test_torch_kernels.py
INTERVAL_KINDS = ("empty", "one_row", "all_rows", "clipped", "inactive",
                  "share_edges", "skewed")


def skewed_intervals(kind, c, nq, n_pad, grid, seed):
    """Learned bounds (s, e (c, nq) int32, active (c, nq) bool, count
    (c,) int32) of one kind, for pairs i = partition * nq + query:

    empty: every pair empty (e <= s) or inactive; one_row: pair 0 spans
    its whole row and the rest are empty; all_rows: every pair spans its
    row; clipped: s < 0, e past n_pad and past count; inactive:
    non-empty intervals on inactive pairs beside active ones;
    share_edges: lengths whose running sums fall on the edges of
    ``grid`` equal shares (a multiple of 2 positions each); skewed: the
    main path's shape, mostly short intervals and a few near the row's
    length. Rows are full except under clipped and skewed, where they
    hold fewer points, down to none."""
    rng = np.random.default_rng(seed)
    n = c * nq
    count = np.full(c, n_pad, np.int32)
    s = rng.integers(0, n_pad, (c, nq)).astype(np.int32)
    e = s.copy()
    active = np.ones((c, nq), bool)
    if kind == "empty":
        e = s - rng.integers(0, 3, (c, nq)).astype(np.int32)
        active = rng.random((c, nq)) < 0.5
        e[~active] = s[~active] + 7          # inactive: not counted
    elif kind == "one_row":
        if n:
            s.flat[0], e.flat[0] = 0, n_pad
    elif kind == "all_rows":
        s[:], e[:] = 0, n_pad
    elif kind == "clipped":
        count = rng.integers(0, n_pad + 1, c).astype(np.int32)
        s = rng.integers(-n_pad, n_pad, (c, nq)).astype(np.int32)
        e = (s + rng.integers(0, 2 * n_pad, (c, nq))).astype(np.int32)
    elif kind == "inactive":
        e = np.minimum(s + rng.integers(1, n_pad, (c, nq)), n_pad).astype(
            np.int32)
        active = rng.random((c, nq)) < 0.5
    elif kind == "share_edges":
        units = np.zeros(n, np.int64)          # shares per pair, sum grid
        units[:min(n, grid)] = grid // max(min(n, grid), 1)
        units[:grid - int(units.sum())] += 1 if n else 0
        length = (2 * units).reshape(c, nq).astype(np.int32)
        assert (length <= n_pad).all()
        s = rng.integers(0, n_pad - length + 1).astype(np.int32)
        e = (s + length).astype(np.int32)
    elif kind == "skewed":
        count = np.linspace(n_pad, 0, c).astype(np.int32)
        length = np.exp(rng.uniform(0, np.log(n_pad), (c, nq))).astype(
            np.int32)
        long = rng.random((c, nq)) < 0.05
        length[long] = n_pad - rng.integers(0, 16, int(long.sum()))
        s = rng.integers(0, n_pad - length + 1).astype(np.int32)
        e = (s + length).astype(np.int32)
        active = (rng.random((c, nq)) < 0.4) | long
    else:
        raise ValueError(kind)
    return s, e, active, count


# -- the point query's fused kernel --------------------------------------

POINT_CASES = ["kdtree_dups", "rtree_overflow", "small_parts"]


def point_points(case, fit_fn):
    """(x, y, partitioner from ``fit_fn``) of each point-query index case
    (the port's ``fit`` and the JAX package's give the same boxes):
    taxi points with duplicates and a run of 151 equal points on kdtree
    boxes that share edges; gaussian points on R-tree leaves, whose
    overflow grid holds data; 200 points on 12 kdtree partitions, each
    holding fewer than the probe width."""
    if case == "kdtree_dups":
        x, y = ds.make("taxi", 4000, seed=3)
        dup = np.random.default_rng(0).integers(0, 4000, 500)
        run = np.full(150, dup[0])
        ix = np.concatenate([np.arange(4000), dup, run])
        x, y = x[ix], y[ix]
        return x, y, fit_fn("kdtree", x, y, 6, seed=0)
    if case == "rtree_overflow":
        x, y = ds.make("gaussian", 3000, seed=5)
        return x, y, fit_fn("rtree", x, y, 9, sample_rate=0.02, seed=1)
    if case == "small_parts":
        x, y = ds.make("uniform", 180, seed=6)
        x, y = np.concatenate([x, x[:20]]), np.concatenate([y, y[:20]])
        return x, y, fit_fn("kdtree", x, y, 12, seed=0)
    raise ValueError(case)


def point_queries(x, y, bounds, overflow, n_data=96):
    """Data points (with duplicates), misses one ulp away (a denormal
    next to 0.0 among them) and at random, points on edges two grid
    boxes share, points in no grid box, and every grid box's corners
    (keys below the first knot and above the last)."""
    rng = np.random.default_rng(7)
    ix = rng.integers(0, len(x), n_data)
    data_x, data_y = x[ix], y[ix]
    miss_x = np.nextafter(data_x[:32], np.float32(np.inf))
    miss_y = data_y[:32].copy()
    rand = rng.random((2, 32)).astype(np.float32)
    g = bounds[:overflow]
    shared = []
    for i in range(overflow):
        for j in range(i + 1, overflow):
            lo = np.maximum(g[i, :2], g[j, :2])
            hi = np.minimum(g[i, 2:], g[j, 2:])
            if (lo <= hi).all():
                shared.append((lo + hi) / 2)
    shared = np.asarray(shared[:24], np.float32).reshape(-1, 2)
    outside = np.asarray([[-0.25, 0.5], [1.5, 1.5], [0.5, -3.0]],
                         np.float32)
    corners = np.concatenate([g[:, :2], g[:, 2:], g[:, [0, 3]]])
    qx = np.concatenate([data_x, miss_x, rand[0], shared[:, 0],
                         outside[:, 0], corners[:, 0]])
    qy = np.concatenate([data_y, miss_y, rand[1], shared[:, 1],
                         outside[:, 1], corners[:, 1]])
    return qx.astype(np.float32), qy.astype(np.float32)


def point_args(ex, qx, qy, dev):
    """``point_query``'s arguments for executor ``ex``'s index on
    ``dev``, and its keywords."""
    parts = ex.parts
    qxt = torch.as_tensor(np.asarray(qx, np.float32))
    qyt = torch.as_tensor(np.asarray(qy, np.float32))
    qk = K.keys_to_f32(K.make_keys(qxt, qyt, ex.spec))
    args = [ex.bounds, parts["knot_keys"], parts["knot_pos"],
            parts["keys_f"], parts["x"], parts["y"], parts["count"], qxt,
            qyt, qk]
    return ([a.to(dev).contiguous() for a in args],
            dict(overflow=ex.index.overflow, probe=ex.index.probe))


@pytest.fixture(scope="module", params=POINT_CASES)
def point_case(request):
    """A port executor (CPU) on each point case's index, and the
    adversarial queries; kdtree_dups has n_pad at its largest count, so
    windows clamp at n_pad - probe."""
    x, y, part = point_points(request.param, fit)
    idx = build_index(x, y, part, device="cpu")
    if request.param == "kdtree_dups":
        idx = build_index(x, y, part, device="cpu",
                          n_pad=int(idx.count.max()) + 3)
    ex = SpatialEngine(idx, device="cpu").executor
    qx, qy = point_queries(x, y, ex.bounds.numpy(), ex.index.overflow)
    return ex, qx, qy


def test_gpu_point_probe_matches_plain(point_case, cuda):
    """The fused point kernel, twice in a row under sync-debug "error",
    bitwise its plain version on the card and on the CPU, on the
    adversarial cases; one launch per call."""
    ex, qx, qy = point_case
    args, kw = point_args(ex, qx, qy, cuda)
    want = t_pp.point_query_plain(*args, **kw)
    n0 = t_pp.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = t_pp.point_query(*args, **kw)
        b = t_pp.point_query(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_pp.launches == n0 + 2
    assert torch.equal(a, want) and torch.equal(b, want)
    cpu_args, _ = point_args(ex, qx, qy, "cpu")
    assert torch.equal(a.cpu(), t_pp.point_query(*cpu_args, **kw))
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("nq", [0, 1, 31, 32, 33, 1024, 4096])
def test_gpu_point_query_batch_sizes(index, cuda, nq):
    """Batches around the warp and block edges, half data points (with
    duplicates), the rest misses one ulp away and random points."""
    x, y, idx = index
    ex = SpatialEngine(idx, device="cpu").executor
    rng = np.random.default_rng(nq)
    ix = rng.integers(0, len(x), nq)
    qx, qy = x[ix].copy(), y[ix].copy()
    qx[nq // 2:] = np.nextafter(qx[nq // 2:], np.float32(np.inf))
    qx[3 * nq // 4:] = rng.random(nq - 3 * nq // 4).astype(np.float32)
    args, kw = point_args(ex, qx, qy, cuda)
    n0 = t_pp.launches
    got = t_pp.point_query(*args, **kw)
    assert t_pp.launches == n0 + (1 if nq else 0)
    assert got.shape == (nq,) and got.dtype == torch.int32
    assert torch.equal(got, t_pp.point_query_plain(*args, **kw))
    assert bool(got[:nq // 2].all())


def test_gpu_point_query_one_launch_per_call(cuda):
    """The engine's point query on the cuda backend: one launch of the
    fused kernel and no other kernel per call, bitwise the torch
    backend's."""
    x, y = ds.make("taxi", 20000, seed=0)
    idx = build_index(x, y, fit("kdtree", x, y, 16, seed=0), device=cuda)
    eng = SpatialEngine(idx, device=cuda)
    plain = SpatialEngine(idx, EngineConfig(backend="torch"), device=cuda)
    rng = np.random.default_rng(2)
    ix = rng.integers(0, len(x), 300)
    qx = torch.as_tensor(np.concatenate([x[ix], rng.random(100).astype(
        np.float32)]), device=cuda)
    qy = torch.as_tensor(np.concatenate([y[ix], rng.random(100).astype(
        np.float32)]), device=cuda)
    for _ in range(3):
        KERN.reset_launch_counts()
        got = eng.point_query(qx, qy)
        launched = {n: c for n, c in KERN.launch_counts().items() if c}
        assert launched == {"point_probe": 1}
        assert torch.equal(got, plain.point_query(qx, qy))
        assert bool(got[:300].all())


@pytest.mark.parametrize("k", [1, 10, 40, 100])
def test_gpu_knn_topk_matches_plain(index, cuda, k):
    x, y, idx = index
    ix = np.random.default_rng(k).integers(0, len(x), 200)
    qx, qy = x[ix].copy(), y[ix].copy()
    qx[::3] += np.float32(1e-4)
    args = _on(cuda, qx, qy, idx.count, idx.x, idx.y)
    gn, gi = t_knn.knn_topk(*args, k=k)
    wn, wi = t_knn.knn_topk_plain(*args, k=k)
    assert torch.equal(gn, wn) and torch.equal(gi, wi)
    assert (gi[-1] == -1).all()                 # the empty padding row


def _knn_rows(rng, c, n_pad, border):
    """Random rows of c partitions in which the points at both sides of
    every slice border (positions b - 1 and b for b a multiple of
    ``border``) sit at one spot, so their squared distances tie for any
    query; rows have count n_pad, part of it, fewer than 128 points,
    one point and none."""
    x = rng.random((c, n_pad)).astype(np.float32)
    y = rng.random((c, n_pad)).astype(np.float32)
    b = np.arange(border, n_pad, border)
    for pos in (b - 1, b):
        x[:, pos], y[:, pos] = np.float32(0.25), np.float32(0.75)
    dup = rng.integers(0, n_pad, 64)          # more ties, off the borders
    dup = dup[~np.isin(dup, np.concatenate([b - 1, b]))]
    x[:, dup[1:]], y[:, dup[1:]] = x[:, dup[:1]], y[:, dup[:1]]
    count = np.linspace(0, n_pad, c).astype(np.int32)[::-1].copy()
    count[-3:] = [100, 1, 0]
    return x, y, count


@pytest.mark.parametrize("k", [1, 10, 16, 17, 40, 128])
@pytest.mark.parametrize("nq", [16, 256])
def test_gpu_knn_topk_ties_across_slices(cuda, nq, k):
    """The kNN kernel at the serving (16) and the exact call's (256)
    query counts, on rows whose equal distances straddle every slice
    border the launcher picks: bitwise the plain version, and each list
    takes the lower position of a tie."""
    rng = np.random.default_rng(nq + k)
    c, n_pad = 8, 30000
    qw, qblocks, slices, slice_len = t_knn.plan(nq, n_pad, c, k, cuda)
    assert slices > 1 and slices * slice_len >= n_pad
    x, y, count = _knn_rows(rng, c, n_pad, slice_len)
    qx = rng.random(nq).astype(np.float32)
    qy = rng.random(nq).astype(np.float32)
    qx[: nq // 4], qy[: nq // 4] = np.float32(0.25), np.float32(0.75)
    args = _on(cuda, qx, qy, count, x, y)
    n0 = t_knn.launches
    gn, gi = t_knn.knn_topk(*args, k=k)
    assert t_knn.launches == n0 + 1
    wn, wi = t_knn.knn_topk_plain(*args, k=k)
    assert torch.equal(gn, wn) and torch.equal(gi, wi)
    # the queries on the tie spot: distance 0 to 2 (slices - 1) points
    ties = min(k, 2 * (slices - 1))
    first = gi[0, : nq // 4, :ties].cpu().numpy()
    borders = np.sort(np.concatenate([np.arange(1, slices) * slice_len - 1,
                                      np.arange(1, slices) * slice_len]))
    assert (first == borders[:ties][None, :]).all()
    assert (gi[-1] == -1).all() and (gi[-2, :, 1:] == -1).all()


def _bounds_and_flags(rng, c, nq, n_pad):
    """Random learned bounds with the edge cases: the whole row, empty
    intervals (e <= s), e past n_pad, and inactive pairs."""
    s = rng.integers(0, n_pad, (c, nq)).astype(np.int32)
    e = (s + rng.integers(-50, n_pad, (c, nq))).astype(np.int32)
    s[:, 0], e[:, 0] = 0, n_pad                 # the whole row
    s[:, 1], e[:, 1] = 100, 100                 # empty
    e = np.minimum(e, n_pad + 64)               # e may pass n_pad
    active = rng.random((c, nq)) < 0.7
    active[:, :2] = True
    return s, e, active


def test_gpu_circle_count_matches_plain(index, cuda):
    """Circles on data points with r = 0 and tiny radii, over rows with
    count = 0 (the padding partitions) and the bounds' edge cases."""
    x, y, idx = index
    rng = np.random.default_rng(6)
    nq, (c, n_pad) = 300, idx.x.shape
    ix = rng.integers(0, len(x), nq)
    cx, cy = x[ix].copy(), y[ix].copy()
    r = rng.uniform(0, 0.05, nq).astype(np.float32)
    r[:20] = 0.0                                # only the centre point
    r[20:40] = 1e-7
    rects = np.stack([cx - r, cy - r, cx + r, cy + r], 1).astype(np.float32)
    circ = np.stack([cx, cy, r], 1).astype(np.float32)
    s, e, active = _bounds_and_flags(rng, c, nq, n_pad)
    args = _on(cuda, rects, s, e, circ, active, idx.count, idx.x, idx.y)
    n0 = t_cf.launches
    got = t_cf.circle_count(*args)
    assert t_cf.launches == n0 + 1
    assert int(got.sum()) > 0 and int(got[-1].sum()) == 0   # count = 0
    assert torch.equal(got, t_cf.circle_count_plain(*args))


@pytest.mark.parametrize("c", [1, 8, 136])
@pytest.mark.parametrize("nq", [0, 1, 16, 256, 1024])
@pytest.mark.parametrize("kind", INTERVAL_KINDS)
def test_gpu_count_kernels_on_skewed_intervals(cuda, kind, nq, c):
    """range_count and circle_count on the skewed interval sets, twice
    in a row (the second launch finds the grid barrier's counters
    reset): one launch per call, each bitwise its plain version."""
    grid = t_rf.grid(cuda)                      # both kernels'
    assert grid > 0
    n_pad = 1200
    rng = np.random.default_rng(nq * 1000 + c)
    x = rng.random((c, n_pad), dtype=np.float32)
    y = rng.random((c, n_pad), dtype=np.float32)
    cx = rng.random(nq, dtype=np.float32)
    cy = rng.random(nq, dtype=np.float32)
    r = rng.uniform(0.0, 0.3, nq).astype(np.float32)
    rects = np.stack([cx - r, cy - r, cx + r, cy + r], 1).astype(np.float32)
    circ = np.stack([cx, cy, r], 1)
    s, e, active, count = skewed_intervals(kind, c, nq, n_pad, grid,
                                           seed=nq + c)
    rect_t, circ_t, s_t, e_t, act_t, cnt_t, x_t, y_t = _on(
        cuda, rects, circ, s, e, active, count, x, y)
    calls = ((t_rf, t_rf.range_count_plain,
              (rect_t, s_t, e_t, act_t, cnt_t, x_t, y_t)),
             (t_cf, t_cf.circle_count_plain,
              (rect_t, s_t, e_t, circ_t, act_t, cnt_t, x_t, y_t)))
    for mod, plain, args in calls:
        fn = mod.range_count if mod is t_rf else mod.circle_count
        n0 = mod.launches
        got = [fn(*args) for _ in range(2)]
        assert mod.launches == n0 + (2 if nq else 0)
        want = plain(*args)
        assert got[0].shape == (c, nq)
        assert torch.equal(got[0], want) and torch.equal(got[1], want)


def _polygons(rng):
    """Random polygons (n_edges < E for most), a concave one with
    horizontal edges, a degenerate sliver, a single vertex, and a
    polygon with no edges."""
    polys, ne = ds.random_polygons(28, (0.1, 0.1, 0.9, 0.9), seed=8,
                                   radius=0.1)
    extra = np.zeros((4, polys.shape[1], 2), np.float32)
    extra[0, :6] = [[0.4, 0.4], [0.6, 0.4], [0.6, 0.5], [0.5, 0.5],
                    [0.5, 0.6], [0.4, 0.6]]
    extra[1, :2] = [[0.3, 0.3], [0.7, 0.7]]
    extra[2, :1] = [[0.5, 0.55]]
    return (np.concatenate([polys, extra]),
            np.concatenate([ne, [6, 2, 1, 0]]).astype(np.int32))


def polygon_set(nq, seed):
    """``nq`` polygons (E = 12), their edge counts and MBRs (closed, of
    their first n_edges vertices): the four of ``_polygons`` with little
    or no area (concave with horizontal edges, sliver, single vertex,
    none) first, then random ones."""
    polys, ne = _polygons(None)
    more, more_ne = ds.random_polygons(max(nq - 4, 0), (0.1, 0.1, 0.9, 0.9),
                                       seed=seed, radius=0.1)
    polys = np.concatenate([polys[-4:], more])[:nq]
    ne = np.concatenate([ne[-4:], more_ne])[:nq].astype(np.int32)
    em = np.arange(polys.shape[1])[None, :, None] < ne[:, None, None]
    mbrs = np.concatenate([np.where(em, polys, 3e38).min(1),
                           np.where(em, polys, -3e38).max(1)],
                          1).astype(np.float32)
    return polys, ne, mbrs


def test_gpu_join_count_matches_plain(index, cuda):
    x, y, idx = index
    rng = np.random.default_rng(7)
    polys, ne = _polygons(rng)
    em = np.arange(polys.shape[1])[None, :, None] < ne[:, None, None]
    mbrs = np.concatenate([np.where(em, polys, 3e38).min(1),
                           np.where(em, polys, -3e38).max(1)],
                          1).astype(np.float32)
    c, n_pad = idx.x.shape
    s, e, active = _bounds_and_flags(rng, c, len(ne), n_pad)
    args = _on(cuda, polys, ne, mbrs, s, e, active, idx.count, idx.x, idx.y)
    n0 = t_pip.launches
    got = t_pip.join_count(*args)
    assert t_pip.launches == n0 + 1
    assert int(got.sum()) > 0 and int(got[-1].sum()) == 0
    assert torch.equal(got, t_pip.join_count_plain(*args))
    assert (got[:, -3:] == 0).all()            # no area, no count


def test_gpu_join_count_at_max_edges(index, cuda):
    """Polygons of 6,140 vertices (the most an earlier kernel could hold
    in a block's shared memory), and of 6,141 and 12,000, past it: the
    kernel reads the vertices from global memory, so each launches and
    equals the plain version bitwise."""
    x, y, idx = index
    c, n_pad = idx.x.shape
    s = np.zeros((c, 2), np.int32)
    e = np.full((c, 2), n_pad, np.int32)
    active = np.ones((c, 2), bool)
    for e_max in (6140, 6141, 12000):
        ang = np.linspace(0, 2 * np.pi, e_max, endpoint=False)
        ring = np.stack([0.5 + 0.3 * np.cos(ang), 0.5 + 0.2 * np.sin(ang)],
                        -1)
        polys = np.stack([ring, ring * 0.5 + 0.2]).astype(np.float32)
        ne = np.asarray([e_max, e_max // 3], np.int32)
        mbrs = np.concatenate([polys.min(1), polys.max(1)], 1)
        args = _on(cuda, polys, ne, mbrs, s, e, active, idx.count, idx.x,
                   idx.y)
        n0 = t_pip.launches
        got = t_pip.join_count(*args)
        assert t_pip.launches == n0 + 1
        assert int(got.sum()) > 0
        assert torch.equal(got, t_pip.join_count_plain(*args))


@pytest.mark.parametrize("c", [1, 8, 136])
@pytest.mark.parametrize("nq", [0, 1, 4, 32, 256])
@pytest.mark.parametrize("kind", INTERVAL_KINDS)
def test_gpu_join_count_on_skewed_intervals(cuda, kind, nq, c):
    """join_count on the count kernels' skewed interval sets, with the
    degenerate polygons first, twice in a row (the second launch finds
    the grid barrier's counters reset): one launch per call, bitwise
    the plain version."""
    grid = t_rf.grid(cuda)
    n_pad = 1200
    rng = np.random.default_rng(nq * 1000 + c + 1)
    x = rng.random((c, n_pad), dtype=np.float32)
    y = rng.random((c, n_pad), dtype=np.float32)
    polys, ne, mbrs = polygon_set(nq, seed=nq + c)
    s, e, active, count = skewed_intervals(kind, c, nq, n_pad, grid,
                                           seed=nq + c)
    args = _on(cuda, polys, ne, mbrs, s, e, active, count, x, y)
    n0 = t_pip.launches
    got = [t_pip.join_count(*args) for _ in range(2)]
    assert t_pip.launches == n0 + (2 if nq else 0)
    want = t_pip.join_count_plain(*args)
    assert got[0].shape == (c, nq)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    if kind == "all_rows" and nq:
        assert int(want.sum()) > 0


def test_gpu_engine_golden_and_backends_agree(cuda):
    """Every golden key replayed with backend="cuda" in gen_golden.py's
    order, and the cuda backend bitwise the torch backend on the card
    for every facade call."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    x, y = ds.make("gaussian", 12000, seed=7)
    part = fit("kdtree", x, y, 12, seed=0)
    rng = np.random.default_rng(11)
    ix = rng.integers(0, len(x), 32)
    qx = np.concatenate([x[ix[:16]],
                         rng.random(16).astype(np.float32) * 2 - 0.5])
    qy = np.concatenate([y[ix[:16]],
                         rng.random(16).astype(np.float32) * 2 - 0.5])
    rects = ds.random_rects(16, 1e-4, part.bounds, seed=13, centers=(x, y))
    cx, cy = x[ix[16:28]], y[ix[16:28]]
    cr = np.full(12, 0.04, np.float32)
    polys, ne = ds.random_polygons(8, part.bounds, seed=17)
    idx = build_index(x, y, part, device=cuda)
    eng = SpatialEngine(idx, EngineConfig(backend="cuda"), device=cuda)
    plain = SpatialEngine(idx, EngineConfig(backend="torch"), device=cuda)
    for e in (eng, plain):
        assert e.point_query(qx, qy).tolist() == golden["point"]
        assert e.range_count(rects).tolist() == golden["range_count"]
        cnt, vids, ok = e.range_query(rects)
        assert cnt.tolist() == golden["range_query_cnt"]
        assert vids.tolist() == golden["range_query_vids"]
        assert ok.tolist() == golden["range_query_ok"]
        assert e.circle_count(cx, cy, cr).tolist() == golden["circle_count"]
        d2, vid = e.knn(qx, qy, 5)
        assert d2.tolist() == golden["knn_d2"]
        assert vid.tolist() == golden["knn_vid"]
        d2, vid = e.knn(qx[:8], qy[:8], 3, mode="exact")
        assert d2.tolist() == golden["knn_exact_d2"]
        assert vid.tolist() == golden["knn_exact_vid"]
        assert e.join_count(polys, ne).tolist() == golden["join_count"]
        assert e.join_count(polys, ne, "full").tolist() == golden[
            "join_count"]
    assert torch.equal(eng.point_query(qx, qy), plain.point_query(qx, qy))
    assert torch.equal(eng.range_count(rects), plain.range_count(rects))
    for a, b in zip(eng.knn(qx, qy, 10, mode="exact"),
                    plain.knn(qx, qy, 10, mode="exact")):
        assert torch.equal(a, b)
    ex, pex = eng.executor, plain.executor
    args = ex._circle_args((cx, cy, cr))
    assert torch.equal(ex._circle_exact(args), pex._circle_exact(args))
    for a, b in zip(eng.circle_query(cx, cy, cr),
                    plain.circle_query(cx, cy, cr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 7, 1000, 3001, 1 << 20])
def test_gpu_morton_matches_plain(cuda, n):
    """The morton kernel against its plain version on the card and on the
    CPU, full-range uint32 values and the edge values included, odd and
    even sizes; a view that is not 16-byte aligned is refused."""
    rng = np.random.default_rng(n)
    qx = rng.integers(0, 1 << 32, n, dtype=np.int64)
    qy = rng.integers(0, 1 << 32, n, dtype=np.int64)
    edge = np.asarray([0, 0xFFFF, 1 << 16, 0xFFFFFFFF], np.int64)
    qx[:4], qy[-4:] = edge[:n], edge[::-1][:n]
    a, b = _on(cuda, qx, qy)
    n0 = t_mo.launches
    got = t_mo.morton_encode(a, b)
    assert t_mo.launches == n0 + 1
    assert torch.equal(got, t_mo.morton_encode_plain(a, b))
    assert torch.equal(got.cpu(), t_mo.morton_encode(a.cpu(), b.cpu()))
    if n > 2:
        with pytest.raises(ValueError, match="aligned"):
            t_mo.morton_encode(a[1:], b[1:])


def _serve_round(x, y, bounds, q, seed, dev):
    """src/repro/launch/serve.py's mixed round, inputs on ``dev``."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), q)
    rects = ds.random_rects(q, 1e-5, bounds, seed=seed, centers=(x, y))
    polys, ne = ds.random_polygons(max(q // 8, 4), bounds, seed=seed)
    px, py, pr, rc, pl, pn = _on(dev, x[ix], y[ix], np.full(
        q, 0.02, np.float32), rects, polys, ne)
    return [(T.PointQuery(), px, py), (T.RangeCount(), rc),
            (T.RangeQuery(), rc), (T.CircleQuery(), px, py, pr),
            (T.Knn(k=10), px, py), (T.SpatialJoin(), pl, pn)]


def test_gpu_steady_serving_round_makes_no_sync(cuda):
    """A steady serving round on a small index, inputs on the card, under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call,
    host_syncs +0, the fallback kernels launched, and every output
    bitwise the torch backend's."""
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    idx = build_index(x, y, part, device=cuda)
    sess = SpatialServeSession(idx, device=cuda)
    plain = SpatialServeSession(idx, EngineConfig(backend="torch"),
                                device=cuda)
    for s in (sess, plain):
        s.warmup(_serve_round(x, y, part.bounds, 16, 0, cuda))
    rnd = _serve_round(x, y, part.bounds, 16, 1, cuda)
    torch.cuda.synchronize()
    syncs = sess.stats()["host_syncs"]
    KERN.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sess.submit_batch(rnd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = KERN.launch_counts()
    assert sess.stats()["host_syncs"] == syncs
    for name in ("spline_search", "range_count", "point_probe", "knn_topk",
                 "circle_count", "point_in_polygon"):
        assert launched[name] > 0, name
    for got, want in zip(out, plain.submit_batch(rnd)):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_gpu_wide_serving_round_is_bucketed(cuda):
    """A steady serving round at src/repro/launch/serve.py's default
    q = 64 on a small index, inputs on the card: the range query, circle
    and kNN requests (64 rows) take the bucketed dispatch. Under
    torch.cuda.set_sync_debug_mode("warn") the round raises exactly one
    sync warning per bucketed request (its one read of the bucket
    sizes), probe_syncs grows by as many, host_syncs stays, and every
    output is bitwise the torch backend's."""
    import warnings
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    idx = build_index(x, y, part, device=cuda)
    sess = SpatialServeSession(idx, device=cuda)
    plain = SpatialServeSession(idx, EngineConfig(backend="torch"),
                                device=cuda)
    for s in (sess, plain):
        s.warmup(_serve_round(x, y, part.bounds, 64, 0, cuda))
    rnd = _serve_round(x, y, part.bounds, 64, 1, cuda)
    torch.cuda.synchronize()
    st = sess.stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = sess.submit_batch(rnd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_sync = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    grew = sess.stats()["probe_syncs"] - st["probe_syncs"]
    assert grew == 3 and n_sync == grew
    assert sess.stats()["host_syncs"] == st["host_syncs"]
    for got, want in zip(out, plain.submit_batch(rnd)):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert plain.stats()["probe_syncs"] == sess.stats()["probe_syncs"]


# -- float32 denormals (read as zero, as XLA:CPU reads them) ---------------

_TINY = np.float32(2.0 ** -126)
_SPECIAL = np.asarray([0.0, 1e-45, -1e-45, 1e-39, -1e-39, _TINY,
                       1.25 * _TINY, 1.5 * _TINY, 2 * _TINY, -1.25 * _TINY],
                      np.float32)


def denormal_points():
    """Gaussian 3,000 points (120 at x = 0.0), the 100 pairs of the
    special values (0.0, +-1e-45, +-1e-39, and normal values near 2^-126
    whose differences are denormal), each special value beside a few
    normal coordinates, and points at a distance from (0.45, 0.0) whose
    square is denormal."""
    x, y = ds.make("gaussian", 3000, seed=5)
    gx, gy = np.meshgrid(_SPECIAL, _SPECIAL)
    nrm = np.asarray([0.05, 0.3, 0.31, 0.6], np.float32)
    sx, sn = np.meshgrid(_SPECIAL, nrm)
    # at x = 0.45, offsets in y whose squares are denormal or at the
    # flush's edge (2^-63 squares to 2^-126)
    h = np.float32(2.0 ** -63)
    off = np.asarray([1e-20, -1e-20, 3e-20, h, np.nextafter(h, np.float32(0)),
                      -np.nextafter(h, np.float32(1))], np.float32)
    x = np.concatenate([x, gx.ravel(), sx.ravel(), sn.ravel(),
                        np.full(off.shape, 0.45, np.float32)])
    y = np.concatenate([y, gy.ravel(), sn.ravel(), sx.ravel(), off])
    return x.astype(np.float32), y.astype(np.float32)


def denormal_queries():
    """A query of each family on the special values: rect edges, circle
    centres and radii, kNN points, polygon vertices and edges."""
    t, f = float(_TINY), np.float32
    d, dd = 1e-45, 1e-39
    rects = np.asarray([
        [d, 0.0, 0.02, 0.35], [-dd, -dd, d, d], [d, d, 1.5 * t, 1.5 * t],
        [1.25 * t, -dd, 0.3, dd], [-d, 0.1, 0.0, 0.9], [t, t, 2 * t, 2 * t],
        [-1.25 * t, -1.25 * t, -d, -d], [0.0, 0.0, dd, 0.5],
        [1.5 * t, 0.0, 0.06, 1.25 * t], [-dd, 0.29, 0.31, 0.32],
        [0.1, 0.1, 0.3, 0.3], [d, d, d, d]], f)
    cx = np.asarray([d, 1.5 * t, 0.0, d, -dd, t, 2 * t, 0.05, 1.25 * t,
                     0.3, -d, 0.45], f)
    cy = np.asarray([d, 1.25 * t, 0.3, 0.3, 0.0, 0.0, 2 * t, 0.05, d,
                     dd, 0.31, 0.0], f)
    r = np.asarray([dd, 0.25 * t, 0.01, 0.02, 1.5 * t, d, t, 0.1, 2 * t,
                    0.01, 0.3, 2e-20], f)
    qx = np.asarray([d, 0.0, 1.5 * t, -dd, dd, t, 0.3, 1.25 * t, -d,
                     0.05, 2 * t, 0.45], f)
    qy = np.asarray([d, 0.0, 1.5 * t, 0.3, 0.31, 2 * t, 0.3, -d, 0.6,
                     dd, 0.0, 0.0], f)
    polys = np.zeros((6, 5, 2), f)
    ne = np.asarray([3, 4, 4, 3, 5, 4], np.int32)
    polys[0, :3] = [[-dd, -dd], [0.2, d], [d, 0.2]]
    polys[1, :4] = [[d, d], [0.1, d], [0.1, 0.1], [d, 0.1]]
    polys[2, :4] = [[t, t], [2 * t, t], [2 * t, 2 * t], [1.25 * t, 2 * t]]
    polys[3, :3] = [[d, 0.3], [0.05, 0.25], [0.05, 0.4]]
    polys[4, :5] = [[-dd, 0.0], [0.0, -dd], [0.31, 0.0], [0.31, 0.6],
                    [-d, 0.6]]
    polys[5, :4] = [[-1.25 * t, -1.25 * t], [0.3, -d], [0.3, 0.3],
                    [dd, 0.3]]
    return {"rects": rects, "cx": cx, "cy": cy, "r": r, "qx": qx,
            "qy": qy, "polys": polys, "ne": ne}


@pytest.fixture(scope="module")
def denormal_index():
    x, y = denormal_points()
    idx = build_index(x, y, fit("rtree", x, y, 9, sample_rate=0.05, seed=1),
                      device="cpu")
    return x, y, L.pad_partitions(idx, 8)


def test_gpu_kernels_on_denormals(denormal_index, cuda):
    """range_count, circle_count, knn_topk and join_count on the
    denormal points and queries (every pair active, whole rows), each
    bitwise its plain version, and the plain version bitwise the CPU's."""
    _, _, idx = denormal_index
    q = denormal_queries()
    c, nq = idx.x.shape[0], len(q["cx"])
    s = np.zeros((c, nq), np.int32)
    e = np.broadcast_to(idx.count.numpy()[:, None], (c, nq)).astype(np.int32)
    act = np.ones((c, nq), bool)
    mbr = np.stack([q["cx"] - q["r"], q["cy"] - q["r"], q["cx"] + q["r"],
                    q["cy"] + q["r"]], -1).astype(np.float32)
    circ = np.stack([q["cx"], q["cy"], q["r"]], -1)
    pg = len(q["ne"])
    jm = np.concatenate([q["polys"].min(1), q["polys"].max(1)], -1)
    calls = [
        (t_rf.range_count, t_rf.range_count_plain,
         (q["rects"], s, e, act, idx.count, idx.x, idx.y)),
        (t_cf.circle_count, t_cf.circle_count_plain,
         (mbr, s, e, circ, act, idx.count, idx.x, idx.y)),
        (t_pip.join_count, t_pip.join_count_plain,
         (q["polys"], q["ne"], jm, s[:, :pg], e[:, :pg], act[:, :pg],
          idx.count, idx.x, idx.y))]
    for fn, plain, args in calls:
        got = fn(*_on(cuda, *args))
        want = plain(*_on(cuda, *args))
        assert torch.equal(got, want), fn.__name__
        assert torch.equal(want.cpu(), plain(*_on("cpu", *args)))
    args = (q["qx"], q["qy"], idx.count, idx.x, idx.y)
    got = t_knn.knn_topk(*_on(cuda, *args), k=6)
    want = t_knn.knn_topk_plain(*_on(cuda, *args), k=6)
    cpu = t_knn.knn_topk_plain(*_on("cpu", *args), k=6)
    for g, w, h in zip(got, want, cpu):
        assert torch.equal(g, w) and torch.equal(w.cpu(), h)


# -- the mutable index (DESIGN.md §11) on the card --------------------------

def flushed_pairs(x, y) -> np.ndarray:
    """(x, y) as one int64 per point, float32 denormals read as zero (a
    delete matches coordinates that way)."""
    def bits(v):
        v = np.where(np.abs(v) < np.finfo(np.float32).tiny, np.float32(0),
                     v).astype(np.float32)
        return v.view(np.uint32).astype(np.int64)
    return (bits(x) << 32) | bits(y)


def update_batches(x, y, n_ins: int, n_del: int, n_buf: int, seed: int):
    """An insert batch and a delete batch on the points (x, y) (vids
    0..N-1), with the denormal cases of a delete: the inserts are
    ``n_ins`` taxi points (seed ``seed``) and (1e-45, 0.5), (-1e-45,
    0.25); the deletes are ``n_del`` originals, ``n_buf`` of the taxi
    inserts, and (0.0, 0.25), which removes the buffered (-1e-45, 0.25).
    (1e-45, 0.5) survives: a later delete of (0.0, 0.5) removes it from
    the main plane once a re-fit has merged it.

    Returns dict(ins=(ix, iy), dele=(dx, dy), removed: the number the
    delete batch removes (every live copy of each coordinate), surv=(sx,
    sy, svid): the surviving points in vid order)."""
    n = len(x)
    ix, iy = ds.make("taxi", n_ins, seed=seed)
    ix = np.concatenate([ix, np.float32([1e-45, -1e-45])])
    iy = np.concatenate([iy, np.float32([0.5, 0.25])])
    rng = np.random.default_rng(seed + 1)
    orig = rng.choice(n, n_del, replace=False)
    buf = rng.choice(n_ins, n_buf, replace=False)
    dx = np.concatenate([x[orig], ix[buf], np.float32([0.0])])
    dy = np.concatenate([y[orig], iy[buf], np.float32([0.25])])
    ax, ay = np.concatenate([x, ix]), np.concatenate([y, iy])
    gone = np.isin(flushed_pairs(ax, ay), flushed_pairs(dx, dy))
    keep = ~gone
    return {"ins": (ix, iy), "dele": (dx, dy), "removed": int(gone.sum()),
            "surv": (ax[keep], ay[keep],
                     np.arange(len(ax), dtype=np.int64)[keep])}


def kernel_cases(ex, rects, qx, qy, kx, ky, circles, polys, ne, k=10):
    """Every query kernel's launches on executor ``ex``'s index, at the
    shapes its exact programs give them: (name, kernel, plain version,
    args, kwargs) per launch. ``spline_search`` and ``range_count`` per
    partition chunk of a range count on ``rects``, ``circle_count`` per
    chunk of the exact circle program on ``circles`` (cx, cy, r),
    ``knn_topk`` per chunk of exact kNN of (kx, ky), ``point_in_polygon``
    (the fused ``join_count``) per chunk of the full join, and the point
    query's one launch on (qx, qy). The learned bounds come from the
    plain backend. Inputs may be numpy; they go to ``ex.device``."""
    from repro_torch.core import queries as Q
    from repro_torch.core.backends import TorchBackend
    dev = ex.device
    kw = dict(radix_bits=ex.index.radix_bits, probe=ex.index.probe)
    c = ex.cfg.part_chunk
    chunks = list(L._chunks(ex.parts, c))
    rect_t, qxt, qyt, kxt, kyt = (
        torch.as_tensor(np.ascontiguousarray(a), device=dev)
        for a in (rects, qx, qy, kx, ky))
    out = []

    def count_args(rs, klo, khi, circ=None):
        ov = Q.rect_overlaps_box(rs, ex.bounds)
        mid = () if circ is None else (circ,)
        for lo, ch in chunks:
            s, e = TorchBackend().bounds(ch, klo, khi, **kw)
            act = ov[:, lo:lo + c].t().contiguous()
            yield ch, (rs, s, e, *mid, act, ch["count"], ch["x"], ch["y"])

    klo, khi = ex._rect_keys(rect_t)
    q2 = torch.cat([klo, khi + 1.0]).contiguous()
    for ch, args in count_args(rect_t, klo, khi):
        out.append(("spline_search", t_ss.spline_search,
                    t_ss.spline_search_plain,
                    (q2, ch["knot_keys"], ch["knot_pos"], ch["radix_table"],
                     ch["keys_f"], ch["radix_kmin"], ch["radix_scale"],
                     ch["n_knots"], ch["count"]), kw))
        out.append(("range_count", t_rf.range_count, t_rf.range_count_plain,
                    args, {}))
    crect, cklo, ckhi, circ = ex._circle_args(circles)
    for _, args in count_args(crect, cklo, ckhi, circ):
        out.append(("circle_count", t_cf.circle_count,
                    t_cf.circle_count_plain, args, {}))
    for _, ch in chunks:
        out.append(("knn_topk", t_knn.knn_topk, t_knn.knn_topk_plain,
                    (kxt, kyt, ch["count"], ch["x"], ch["y"]), {"k": k}))
    jpoly, jne, jmbr_k = ex._join_args((polys, ne))
    jmbrs = jmbr_k[:, :4].contiguous()
    jklo, jkhi = jmbr_k[:, 4].contiguous(), jmbr_k[:, 5].contiguous()
    ov = Q.rect_overlaps_box(jmbrs, ex.bounds)
    for lo, ch in chunks:
        s, e = TorchBackend().bounds(ch, jklo, jkhi, **kw)
        out.append(("point_in_polygon", t_pip.join_count,
                    t_pip.join_count_plain,
                    (jpoly, jne, jmbrs, s, e,
                     ov[:, lo:lo + c].t().contiguous(), ch["count"],
                     ch["x"], ch["y"]), {}))
    qk = K.keys_to_f32(K.make_keys(qxt, qyt, ex.spec))
    p = ex.parts
    out.append(("point_probe", t_pp.point_query, t_pp.point_query_plain,
                (ex.bounds, p["knot_keys"], p["knot_pos"], p["keys_f"],
                 p["x"], p["y"], p["count"], qxt, qyt, qk),
                {"overflow": ex.index.overflow, "probe": ex.index.probe}))
    return out


def check_kernel_cases(cases) -> dict:
    """Each case's kernel bitwise its plain version; {name: max_abs_err}
    (0 everywhere, or an AssertionError)."""
    err = {}
    for name, fn, plain, args, kw in cases:
        got, want = fn(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max(float((g.double() - w.double()).abs().max())
                if g.numel() else 0.0 for g, w in zip(got, want))
        err[name] = max(err.get(name, 0.0), e)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    return err


def _small_update_case():
    """taxi 20,000 points, kdtree 16, and update_batches on them (600
    inserts, 250 original deletes, 150 buffered)."""
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    return x, y, part, update_batches(x, y, 600, 250, 150, seed=5)


def _families(x, y, part, seed=9):
    """One call of each family on (executor) -> result."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), 48)
    qx = np.concatenate([x[ix], rng.random(16).astype(np.float32),
                         np.float32([1e-45, 0.0])])
    qy = np.concatenate([y[ix], rng.random(16).astype(np.float32),
                         np.float32([0.5, 0.5])])
    rects = ds.random_rects(32, 1e-4, part.bounds, seed=seed, centers=(x, y))
    r = np.full(len(qx), 0.01, np.float32)
    polys, ne = ds.random_polygons(8, part.bounds, seed=seed)
    return {
        "point": lambda e: e.run(T.PointQuery(), qx, qy),
        "range_count": lambda e: e.run(T.RangeCount(), rects),
        "range": lambda e: e.run(T.RangeQuery(), rects, strict=True),
        "circle": lambda e: e.run(T.CircleQuery(), qx, qy, r, strict=True),
        "circle_mat": lambda e: e.run(T.CircleQuery(materialize=True), qx,
                                      qy, r, strict=True),
        "circle_exact": lambda e: e._circle_exact(e._circle_args((qx, qy,
                                                                  r))),
        "knn": lambda e: e.run(T.Knn(k=10), qx, qy, strict=True),
        "knn_exact": lambda e: e.run(T.Knn(k=10, mode="exact"), qx, qy),
        "join": lambda e: e.run(T.SpatialJoin(), polys, ne, strict=True),
        "join_full": lambda e: e.run(T.SpatialJoin(mode="full"), polys, ne),
    }, (rects, qx, qy, qx, qy, (qx, qy, r), polys, ne)


def _same_as_fresh(name, got, want):
    """Counts, kNN distances and id order bitwise; materialized ids equal
    as sets (the two indexes' window widths differ by the delta plane)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name in ("range", "circle_mat"):
        assert torch.equal(got[0], want[0]), name
        for a, b in zip(got[1].tolist(), want[1].tolist()):
            assert {v for v in a if v >= 0} == {v for v in b if v >= 0}
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_gpu_updates_cuda_matches_torch_backend(cuda):
    """Inserts and deletes (the denormal cases among them) on a small
    index: every family on the cuda backend bitwise the torch backend on
    the card, before and after the re-fit, and both bitwise a fresh build
    of the surviving points (materialized ids as sets); the kernels
    launch on the mutated index."""
    x, y, part, u = _small_update_case()
    idx = build_index(x, y, part, device=cuda)
    ex = T.Executor(idx, device=cuda)
    pl = T.Executor(idx, EngineConfig(backend="torch"), device=cuda)
    for e in (ex, pl):
        vids = e.run(T.InsertBatch(), *u["ins"])
        assert vids.tolist() == list(range(len(x), len(x) + len(u["ins"][0])))
        assert e.run(T.DeleteBatch(), *u["dele"]) == u["removed"]
    assert ex.index.delta_cap > 0
    fams, _ = _families(x, y, part)
    sx, sy, svid = u["surv"]
    results = []
    for refit in (False, True):
        if refit:
            assert ex.refit() == pl.refit()
            assert ex.index.epoch == pl.index.epoch == 3
        KERN.reset_launch_counts()
        got = {n: f(ex) for n, f in fams.items()}
        launched = KERN.launch_counts()
        for n in ("spline_search", "range_count", "point_probe",
                  "knn_topk", "circle_count", "point_in_polygon"):
            assert launched[n] > 0, (n, refit)
        for n, f in fams.items():
            want = f(pl)
            g = got[n] if isinstance(got[n], tuple) else (got[n],)
            w = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(a, b) for a, b in zip(g, w)), (n, refit)
        results.append(got)
    fresh = T.Executor(build_index(sx, sy, part, vid=svid,
                                   n_pad=ex.index.n_pad, device=cuda),
                       device=cuda)
    for n, f in fams.items():
        want = f(fresh)
        for got in results:
            _same_as_fresh(n, got[n], want)
    for n in ("key", "x", "y", "vid", "count"):
        assert torch.equal(getattr(ex.index, n), getattr(fresh.index, n))
    # the denormal case on the main plane, after the re-fit merged it
    pq = (np.float32([1e-45]), np.float32([0.5]))
    assert ex.run(T.PointQuery(), *pq).tolist() == [True]
    assert ex.run(T.DeleteBatch(), np.float32([0.0]),
                  np.float32([0.5])) == 1
    assert ex.run(T.PointQuery(), *pq).tolist() == [False]


def test_gpu_kernels_on_mutated_planes(cuda):
    """Each query kernel bitwise its plain version on tombstoned planes
    (coordinates 3e38 and vid -1 inside count) and on the re-fit planes
    (merged rows, a wider n_pad, a larger probe)."""
    x, y, part, u = _small_update_case()
    ex = T.Executor(build_index(x, y, part, device=cuda), device=cuda)
    ex.run(T.InsertBatch(), *u["ins"])
    # a long duplicate run in the fullest partition, of a point that no
    # delete removes: the re-fit widens the probe, and the merged row
    # outgrows n_pad
    row = int(ex.index.count.argmax())
    px, py = (getattr(ex.index, a)[row].cpu().numpy() for a in "xy")
    ok = ~np.isin(flushed_pairs(px, py), flushed_pairs(*u["dele"]))
    j = int(np.flatnonzero(ok)[0])
    ex.run(T.InsertBatch(), np.full(300, px[j], np.float32),
           np.full(300, py[j], np.float32))
    ex.run(T.DeleteBatch(), *u["dele"])
    assert (ex.index.vid < 0).logical_and(
        torch.arange(ex.index.n_pad, device=cuda)[None, :]
        < ex.index.count[:, None]).any()
    _, args = _families(x, y, part)
    before = (ex.index.n_pad, ex.index.probe)
    err = check_kernel_cases(kernel_cases(ex, *args))
    ex.refit()
    assert ex.index.n_pad > before[0] and ex.index.probe > before[1]
    err2 = check_kernel_cases(kernel_cases(ex, *args))
    assert set(err) == set(err2) == {
        "spline_search", "range_count", "circle_count", "knn_topk",
        "point_in_polygon", "point_probe"}
    assert max(err.values()) == max(err2.values()) == 0


def test_gpu_denormal_deletes(cuda):
    """A delete reads float32 denormals as zero on the card too: a point
    built at (1e-45, 0.5) and a buffered insert at (-1e-45, 0.25) are
    removed by deletes at x = 0.0, on both backends alike."""
    px, py = ds.make("uniform", 1500, seed=71)
    px = np.concatenate([px, np.float32([1e-45])]).astype(np.float32)
    py = np.concatenate([py, np.float32([0.5])]).astype(np.float32)
    part = fit("kdtree", px, py, 4, seed=0)
    out = []
    for bk in ("cuda", "torch"):
        e = T.Executor(build_index(px, py, part, device=cuda),
                       EngineConfig(backend=bk), device=cuda)
        e.run(T.InsertBatch(), np.float32([-1e-45, 0.7]),
              np.float32([0.25, 0.7]))
        q = (np.float32([1e-45, -1e-45, 0.7]), np.float32([0.5, 0.25, 0.7]))
        assert e.run(T.PointQuery(), *q).tolist() == [True, True, True]
        assert e.run(T.DeleteBatch(), np.float32([0.0, 0.0]),
                     np.float32([0.5, 0.25])) == 2
        assert e.run(T.PointQuery(), *q).tolist() == [False, False, True]
        out.append(e.run(T.Knn(k=3, mode="exact"), *q))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_gpu_serving_after_insert_makes_no_sync(cuda):
    """An insert between serving rounds: the steady round after it makes
    no synchronising call (sync-debug "error"), host_syncs +0, outputs
    bitwise the torch backend's; with delta_occupancy low the insert
    schedules a re-fit, maintain() runs it and pending_refit empties."""
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    idx = build_index(x, y, part, device=cuda)
    cfg = dict(delta_occupancy=0.001)
    sess = SpatialServeSession(idx, EngineConfig(**cfg), device=cuda)
    plain = SpatialServeSession(idx, EngineConfig(backend="torch", **cfg),
                                device=cuda)
    for s in (sess, plain):
        s.warmup(_serve_round(x, y, part.bounds, 16, 0, cuda))
    bx, by = ds.make("taxi", 256, seed=4)
    for s in (sess, plain):
        s.insert(bx, by)
        assert s.stats()["pending_refit"]
    rnd = _serve_round(x, y, part.bounds, 16, 1, cuda)
    for refit in (False, True):
        torch.cuda.synchronize()
        syncs = sess.stats()["host_syncs"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sess.submit_batch(rnd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert sess.stats()["host_syncs"] == syncs
        for got, want in zip(out, plain.submit_batch(rnd)):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        if not refit:
            moved = sess.maintain()
            assert moved == plain.maintain() and moved.get("refit")
            assert not sess.stats()["pending_refit"]
            assert sess.stats()["refits"] == 1


# -- the streaming serve scheduler (serve/scheduler.py) ---------------------

def _scheduler_case(dev, n_req, **cfg):
    """A small index on the card, a warmed session, and the serve
    launcher's single-query traffic (point, range count, 10-NN, circle
    round-robin) with its inputs on the card; plus each request's
    serial result."""
    from repro_torch.launch.serve import scheduler_requests
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    sess = SpatialServeSession(build_index(x, y, part, device=dev),
                               EngineConfig(**cfg), device=dev)
    reqs = [(s, *_on(dev, *a)) for s, *a in
            scheduler_requests(x, y, part, n_req)]
    sess.warmup(reqs[:4])
    serial = [sess.submit(*r) for r in reqs]
    return sess, reqs, serial


def _same_tree(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_gpu_scheduler_drain_matches_serial(cuda):
    """Drain mode on the card: one coalesced batch per spec (64
    single-query requests -> four of 16), each launching its kernels,
    every ticket bitwise its serial result."""
    sess, reqs, serial = _scheduler_case(cuda, 64)
    sched = sess.scheduler(start=False)
    tickets = [sched.submit(*r) for r in reqs]
    KERN.reset_launch_counts()
    sched.drain()
    launched = KERN.launch_counts()
    batches = [e for e in sched.events if e[0] == "batch"]
    assert [(e[1], e[2], e[3]) for e in batches] == [
        (n, 16, 16) for n in ("point", "range_count", "knn10", "circle")]
    for name in ("spline_search", "range_count", "point_probe", "knn_topk",
                 "circle_count"):
        assert launched[name] > 0, name
    for i, (t, want) in enumerate(zip(tickets, serial)):
        assert t.batched == 16 and _same_tree(t.result(), want), i
    assert sched.stats()["maintain_busy"] == 0
    sched.close()


def maintain_syncs(ex) -> list:
    """Wrap ``ex.maintain`` to tally the host syncs maintenance makes
    (its reads of the stashed ok flags); returns the one-element tally,
    so a window's dispatches' own syncs are the rest."""
    tally, run = [0], ex.maintain

    def counted():
        h = ex.host_syncs
        try:
            return run()
        finally:
            tally[0] += ex.host_syncs - h

    ex.maintain = counted
    return tally


def test_gpu_scheduler_worker_concurrent_submitters(cuda):
    """Worker mode on the card, 8 client threads: every ticket resolves
    bitwise its serial result, and the dispatches read no ok flag on the
    host (host_syncs grows only by idle maintenance's reads)."""
    import threading
    sess, reqs, serial = _scheduler_case(cuda, 128)
    ex = sess.executor
    tally = maintain_syncs(ex)
    syncs = ex.host_syncs
    tickets = [None] * len(reqs)
    with sess.scheduler() as sched:
        def client(k):
            for i in range(k, len(reqs), 8):
                tickets[i] = sched.submit(*reqs[i])
                tickets[i].result(120.0)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        st = sched.stats()
    assert st["reads"] == len(reqs) and st["maintain_busy"] == 0
    assert ex.host_syncs - syncs == tally[0]
    for i, (t, want) in enumerate(zip(tickets, serial)):
        assert _same_tree(t.result(), want), i


def test_gpu_scheduler_ticket_waits_for_the_device(cuda):
    """A ticket resolves only once its batch completed on the device: the
    executor is made to queue a ~50 ms sleep kernel after each batch, and
    when result() returns the stream has no work left."""
    sess, reqs, serial = _scheduler_case(cuda, 8,
                                         serve_idle_maintain=False)
    run = sess.executor.run

    def slow_run(spec, *args, **kw):
        out = run(spec, *args, **kw)
        torch.cuda._sleep(100_000_000)
        return out

    sess.executor.run = slow_run
    torch.cuda.synchronize()
    with sess.scheduler() as sched:
        for r, want in zip(reqs, serial):
            got = sched.submit(*r).result(60.0)
            assert torch.cuda.current_stream().query()
            assert _same_tree(got, want)


# -- CUDA graphs: the executor's program cache (DESIGN.md §14) -------------

def capture_alone(fn, args, kw):
    """One kernel wrapper ``fn(*args, **kw)`` captured alone into a CUDA
    graph, after one eager call (its first use). Returns (the eager
    output, the outputs of two replays, {kernel: launches the capture
    recorded}). Before each replay the graph's outputs are filled with a
    sentinel, so an element the graph did not write shows."""
    eager = fn(*args, **kw)
    torch.cuda.synchronize()
    n0 = KERN.launch_counts()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="thread_local")
        out = fn(*args, **kw)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    n1 = KERN.launch_counts()
    out = out if isinstance(out, tuple) else (out,)
    replays = []
    for _ in range(2):
        for o in out:
            o.fill_(True if o.dtype == torch.bool else -7)
        g.replay()
        torch.cuda.synchronize()
        replays.append(tuple(o.clone() for o in out))
    eager = eager if isinstance(eager, tuple) else (eager,)
    return eager, replays, {n: n1[n] - n0[n] for n in n1 if n1[n] != n0[n]}


def launcher_cases(ex, args) -> dict:
    """{kernel: (wrapper, args, kwargs)}: the first launch of each query
    kernel on executor ``ex`` (``kernel_cases``), and morton on the
    index's quantized coordinates."""
    cases = {}
    for name, fn, _plain, a, kw in kernel_cases(ex, *args):
        cases.setdefault(name, (fn, a, kw))
    b, bits = ex.spec.bounds, ex.spec.bits_per_dim
    n = min(int(ex.index.count[0]), 4096)
    qx = K.quantize(ex.index.x[0, :n].contiguous(), b[0], b[2], bits)
    qy = K.quantize(ex.index.y[0, :n].contiguous(), b[1], b[3], bits)
    cases["morton"] = (t_mo.morton_encode, (qx, qy), {})
    return cases


def graph_count(ex) -> int:
    """The CUDA graphs an executor holds."""
    from repro_torch.core.executor import _Graph
    return sum(isinstance(r, _Graph) for d in ex._cache.values()
               for r in d._fns.values())


def _tup(out):
    return out if isinstance(out, tuple) else (out,)


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(_tup(a), _tup(b),
                                                   strict=True))


def test_gpu_each_launcher_captured_alone(cuda):
    """Each of the seven launchers (the interval scans' cooperative
    launches, knn_topk's occupancy-planned launch among them) captured
    alone into a one-launch CUDA graph: both replays bitwise the eager
    launch, and the capture recorded exactly one launch."""
    x, y, part, _ = _small_update_case()
    ex = T.Executor(build_index(x, y, part, device=cuda), device=cuda)
    _, args = _families(x, y, part)
    cases = launcher_cases(ex, args)
    assert set(cases) == set(KERN.KERNELS)
    for name, (fn, a, kw) in cases.items():
        eager, replays, launched = capture_alone(fn, a, kw)
        assert launched == {name: 1}, (name, launched)
        for rep in replays:
            assert _same(eager, rep), name


def _serving_calls(args):
    """The serving (non-strict) call of each adaptive family."""
    rects, qx, qy, _, _, circ, polys, ne = args
    return {
        "range": lambda e: e.run(T.RangeQuery(), rects),
        "circle": lambda e: e.run(T.CircleQuery(), *circ),
        "circle_mat": lambda e: e.run(T.CircleQuery(materialize=True),
                                      *circ),
        "knn": lambda e: e.run(T.Knn(k=10), qx, qy),
        "join": lambda e: e.run(T.SpatialJoin(), polys, ne),
    }


def test_gpu_graph_replays_match_eager_and_torch_backend(cuda):
    """Every family, strict and serving: the first call (eager), the
    second (captured, then replayed), two more graph replays, an
    executor running eagerly and the torch backend (its programs graphs
    too) are bitwise alike; the replays launch the kernels (counted per
    capture x replays) and capture nothing new; the strict kNN (it
    reads the host) stays eager."""
    x, y, part, _ = _small_update_case()
    idx = build_index(x, y, part, device=cuda)
    g = T.Executor(idx, device=cuda)
    e = T.Executor(idx, device=cuda)
    e.cuda_graphs = False
    pl = T.Executor(idx, EngineConfig(backend="torch"), device=cuda)
    fams, args = _families(x, y, part)
    fams.update({f"serve_{n}": f for n, f in _serving_calls(args).items()})
    for name, f in fams.items():
        first = f(g)
        again = [f(g)]
        captured = g.compile_ms_total
        KERN.reset_launch_counts()
        again += [f(g) for _ in range(2)]
        launched = KERN.launch_counts()
        assert g.compile_ms_total == captured, name
        assert sum(launched.values()) > 0 or name in ("range", "circle",
                                                      "circle_mat", "knn",
                                                      "join"), name
        for r in again:
            assert _same(first, r), name
        assert _same(first, f(e)), name
        for _ in range(2):          # the second call captures
            assert _same(first, f(pl)), name
    assert graph_count(g) > 0 and graph_count(e) == 0
    assert graph_count(pl) > 0
    assert g.graph_recaptures == 0
    strict_knn = [d for k, d in g._cache.items()
                  if k[2] == ("knn", 10) and k[3] == "w"]
    assert strict_knn and all(r is d.fn for d in strict_knn
                              for r in d._fns.values())


def test_gpu_two_graphs_of_one_pool_replay_in_reverse_order(cuda):
    """Two graphs of one executor's pool (the point program, captured
    first, and the range count; each captured on its second call),
    replayed in the reverse of their capture order on new inputs each
    time: bitwise an eager executor."""
    x, y, part, _ = _small_update_case()
    idx = build_index(x, y, part, device=cuda)
    g = T.Executor(idx, device=cuda)
    e = T.Executor(idx, device=cuda)
    e.cuda_graphs = False
    rng = np.random.default_rng(3)

    def point(seed):
        ix = np.random.default_rng(seed).integers(0, len(x), 64)
        return T.PointQuery(), x[ix], y[ix]

    def rcount(seed):
        return T.RangeCount(), ds.random_rects(64, 1e-4, part.bounds,
                                               seed=seed, centers=(x, y))

    for req in (point(0), point(0), rcount(0)):
        g.run(*req)
    assert graph_count(g) == 1          # a signature seen once is eager
    g.run(*rcount(0))
    assert graph_count(g) == 2 and g._pool is not None
    for seed in rng.integers(1, 1000, 4).tolist():
        for req in (rcount(seed), point(seed)):
            assert torch.equal(g.run(*req), e.run(*req))
    assert graph_count(g) == 2


def test_gpu_replay_after_updates_equals_fresh_build(cuda):
    """Graphs captured on an index with delta buffers, then an insert, a
    delete and a Refit(): the insert and the delete keep every shape, so
    the same graphs replay (no capture, no pointer mismatch: the planes
    are written in place) and answer bitwise as a fresh build of the
    live points; after the re-fit too."""
    x, y, part, u = _small_update_case()
    g = T.Executor(build_index(x, y, part, delta_cap=1024, device=cuda),
                   device=cuda)
    fams, args = _families(x, y, part)
    serve = _serving_calls(args)
    for f in fams.values():           # strict: the sticky tiers settle
        f(g)
    calls = dict(serve, point=fams["point"],
                 range_count=fams["range_count"],
                 circle_exact=fams["circle_exact"],
                 knn_exact=fams["knn_exact"], join_full=fams["join_full"])
    for _ in range(2):                # capture every serving program
        for f in calls.values():
            f(g)
    n_graphs, se0 = graph_count(g), g.index.shape_epoch

    def check(sx, sy, svid, what):
        fresh = T.Executor(build_index(sx, sy, part, vid=svid,
                                       n_pad=g.index.n_pad, device=cuda),
                           device=cuda)
        fresh.cuda_graphs = False
        fresh._sticky.update(g._sticky)
        for name, f in calls.items():
            _same_as_fresh(name, f(g), f(fresh))

    ax = np.concatenate([x, u["ins"][0]])
    ay = np.concatenate([y, u["ins"][1]])
    g.run(T.InsertBatch(), *u["ins"])
    assert g.index.shape_epoch == se0
    captured = g.compile_ms_total
    check(ax, ay, np.arange(len(ax)), "insert")
    assert g.compile_ms_total == captured and graph_count(g) == n_graphs
    assert g.run(T.DeleteBatch(), *u["dele"]) == u["removed"]
    assert g.index.shape_epoch == se0
    check(*u["surv"], "delete")
    assert g.compile_ms_total == captured and graph_count(g) == n_graphs
    g.run(T.Refit())
    check(*u["surv"], "refit")
    assert g.graph_recaptures == 0


def test_gpu_serving_round_replays_graphs_without_sync(cuda):
    """A steady q = 16 round through CUDA graphs under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call,
    host_syncs +0, no capture, the kernels launched (by replays), and
    every output bitwise an eager session's and the torch backend's."""
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    idx = build_index(x, y, part, device=cuda)
    sess = SpatialServeSession(idx, device=cuda)
    eager = SpatialServeSession(idx, device=cuda)
    eager.executor.cuda_graphs = False
    plain = SpatialServeSession(idx, EngineConfig(backend="torch"),
                                device=cuda)
    for s in (sess, eager, plain):
        s.warmup(_serve_round(x, y, part.bounds, 16, 0, cuda))
    sess.submit_batch(_serve_round(x, y, part.bounds, 16, 2, cuda))
    rnd = _serve_round(x, y, part.bounds, 16, 1, cuda)
    torch.cuda.synchronize()
    st0, n0 = sess.stats(), graph_count(sess.executor)
    KERN.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sess.submit_batch(rnd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = KERN.launch_counts()
    st = sess.stats()
    assert st["host_syncs"] == st0["host_syncs"]
    assert st["compile_ms_total"] == st0["compile_ms_total"]
    assert st["cache_size"] == st0["cache_size"]
    assert graph_count(sess.executor) == n0 > 0
    for name in ("spline_search", "range_count", "point_probe", "knn_topk",
                 "circle_count", "point_in_polygon"):
        assert launched[name] > 0, name
    for got, a, b in zip(out, eager.submit_batch(rnd),
                         plain.submit_batch(rnd)):
        assert _same(got, a) and _same(got, b)


# -- the precompile worker (DESIGN.md §14, async precompilation) ----------

class _Gate:
    """A local program that, while it is being captured, holds the
    capture open after recording its launches until ``go`` is set
    (``inside`` is set once it holds); run eagerly it just runs."""
    host_reads = False

    def __init__(self, fn):
        self.fn = fn
        self.inside = threading.Event()
        self.go = threading.Event()

    def __call__(self, *args):
        out = self.fn(*args)
        if torch.cuda.is_current_stream_capturing():
            self.inside.set()
            assert self.go.wait(120.0)
        return out


def _worker_case(dev, seed=0):
    """A graphs-on executor on a small index, an eager executor on the
    same index, and two request kinds at width 64 on the card: a point
    batch and a range-count batch."""
    x, y = ds.make("taxi", 20000, seed=0)
    part = fit("kdtree", x, y, 16, seed=0)
    idx = build_index(x, y, part, device=dev)
    ex = T.Executor(idx, device=dev)
    eager = T.Executor(idx, device=dev)
    eager.cuda_graphs = False
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), 64)
    pq = (T.PointQuery(), *_on(dev, x[ix], y[ix]))
    rq = (T.RangeCount(), *_on(dev, ds.random_rects(
        64, 1e-4, part.bounds, seed=seed + 1, centers=(x, y))))
    return ex, eager, pq, rq


def _gated_worker_capture(ex, req):
    """Start ``ex``'s precompile worker and have it capture the program
    of ``req`` at its signature (run once eagerly first, so the worker
    captures a signature the serving thread has seen), held open by a
    _Gate. Returns (gate, dispatcher, signature) once the capture
    holds."""
    ex.run(*req)
    spec = req[0]
    key = ex._key(("range_count",) if isinstance(spec, T.RangeCount)
                  else ("point",))
    disp = ex._cache[key]
    sig = next(iter(disp._fns))
    gate = _Gate(disp.fn)
    disp.fn = gate
    ex.start_precompiler()
    assert ex.precompile_async(*req) is not None
    assert gate.inside.wait(120.0), "the worker's capture did not start"
    return gate, disp, sig


def _by_kernel(by_module) -> dict:
    """A _Graph's launch tally {module name: n} by kernel name."""
    return {n: by_module.get(m.__name__, 0)
            for n, m in KERN.KERNELS.items()}


def _pool_bytes(pool) -> int:
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@pytest.mark.parametrize("op", ["replay", "host_read", "event_sync",
                                "alloc", "device_sync"])
def test_gpu_worker_captures_while_serving_runs(cuda, op):
    """The worker captures the range count at a signature the serving
    thread ran once, while the serving thread, with the capture open,
    replays the point graph (under sync-debug "error": host_syncs +0),
    reads the host, waits on an event, allocates 256 MiB, or
    synchronizes the device under the capture lock (a bare device-wide
    sync fails during any capture). The capture succeeds; its graph replays bitwise the
    eager launch; the launch counts are exact on both threads (the
    serving thread's replays and eager run, the worker's eager run, and
    nothing of the capture); the collector is off only while the
    capture is open."""
    from repro_torch.core.executor import _Graph
    ex, eager, pq, rq = _worker_case(cuda)
    ex.run(*pq)
    ex.run(*pq)                           # the point graph, inline
    gp = [d._fns for k, d in ex._cache.items() if k[2] == ("point",)][0]
    gp = next(iter(gp.values()))
    assert isinstance(gp, _Graph)
    serving_ms = ex.capture_ms["serving"]
    torch.cuda.synchronize()
    KERN.reset_launch_counts()
    # the serving thread's eager first call, then the worker's eager
    # zero-input run and its capture, held open
    gate, disp, sig = _gated_worker_capture(ex, rq)
    assert not gc.isenabled()
    h0, replays = ex.host_syncs, 0
    if op == "replay":
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [ex.run(*pq) for _ in range(5)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        replays = 5
        assert ex.host_syncs == h0
    elif op == "host_read":
        outs = [ex.run(*pq)]
        replays = 1
        host = outs[0].tolist()
    elif op == "event_sync":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    elif op == "alloc":
        t = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
        t.fill_(1)
        assert int(t[-1]) == 1
        del t
    else:
        # a device-wide sync fails while any stream captures
        # (cudaErrorStreamCaptureUnsupported, measured): the executor's
        # one (_exercise_families) runs under the capture lock, so it
        # waits for the capture to close
        def device_sync():
            with ex._capture_lock:
                torch.cuda.synchronize()

        th = threading.Thread(target=device_sync)
        th.start()
        th.join(0.5)
        assert th.is_alive()
    gate.go.set()
    if op == "device_sync":
        th.join(120.0)
        assert not th.is_alive()
    assert ex.precompile_quiesce(120.0)
    torch.cuda.synchronize()
    launched = KERN.launch_counts()
    assert gc.isenabled()
    assert ex.async_capture_errors == 0, op
    g = disp._fns[sig]
    assert isinstance(g, _Graph) and ex.async_compiles == 1, op
    # two eager runs of the range count launched what its capture
    # recorded, each; the capture itself added nothing
    want = {n: replays * c + 2 * w for (n, c), w in zip(
        _by_kernel(gp.launches).items(), _by_kernel(g.launches).values())}
    assert launched == want, (op, launched, want)
    assert sum(g.launches.values()) > 0
    assert ex.capture_ms["serving"] == serving_ms and \
        ex.capture_ms["worker"] > 0
    want = eager.run(*pq)
    for o in outs if replays else ():
        assert torch.equal(o, want), op
    if op == "host_read":
        assert host == want.tolist()
    disp.fn = gate.fn
    want = eager.run(*rq)
    torch.cuda.synchronize()
    KERN.reset_launch_counts()
    for _ in range(2):
        assert torch.equal(ex.run(*rq), want), op
    torch.cuda.synchronize()
    assert KERN.launch_counts() == {
        n: 2 * c for n, c in _by_kernel(g.launches).items()}
    ex.stop_precompiler()


def test_gpu_second_call_captures_on_the_worker(cuda):
    """With the worker running, a signature's second call captures
    nothing on the serving thread: it runs eagerly and hands the capture
    over; the worker installs the graph, which the third call replays.
    Every family's serving calls, three times each: the serving thread's
    capture time stays 0 and every result is bitwise the eager
    executor's."""
    from repro_torch.core.executor import _Graph
    x, y, part, _ = _small_update_case()
    idx = build_index(x, y, part, device=cuda)
    ex = T.Executor(idx, device=cuda)
    eager = T.Executor(idx, device=cuda)
    eager.cuda_graphs = False
    fams, args = _families(x, y, part)
    for f in fams.values():               # strict: the tiers settle
        f(ex)
        f(eager)
    assert ex.start_precompiler()
    serving_ms = ex.capture_ms["serving"]
    calls = dict(_serving_calls(args), point=fams["point"],
                 range_count=fams["range_count"],
                 knn_exact=fams["knn_exact"], join_full=fams["join_full"])
    for name, f in calls.items():
        want = f(eager)
        for _ in range(2):
            assert _same(f(ex), want), name
        assert ex.capture_ms["serving"] == serving_ms, name
    assert ex.precompile_quiesce(120.0)
    n = graph_count(ex)
    for name, f in calls.items():
        assert _same(f(ex), f(eager)), name
    assert graph_count(ex) == n > 0
    assert ex.capture_ms["serving"] == serving_ms
    assert ex.capture_ms["worker"] > 0 and ex.async_compiles > 0
    assert ex.async_capture_errors == 0
    fused = [d for k, d in ex._cache.items() if k[3] == "fused"]
    assert fused and all(isinstance(r, _Graph) for d in fused
                         for r in d._fns.values())
    ex.stop_precompiler()


def test_gpu_no_two_captures_of_one_executor_at_once(cuda):
    """While the worker's capture is open, an inline capture on the same
    executor (another thread) waits for the capture lock; a capture on
    another executor runs meanwhile, and the collector comes back on
    only when the last open capture closes. Both graphs replay bitwise
    the eager launches."""
    from repro_torch.core.executor import _Graph
    ex, eager, pq, rq = _worker_case(cuda)
    ex2, _, _, rq2 = _worker_case(cuda, seed=5)
    gate, disp, sig = _gated_worker_capture(ex, rq)
    ex.run(*pq)                           # the point program, eager
    pdisp = [d for k, d in ex._cache.items() if k[2] == ("point",)][0]
    psig = next(iter(pdisp._fns))
    inline = threading.Thread(target=pdisp.warm, args=(psig,))
    inline.start()
    inline.join(0.5)
    assert inline.is_alive(), "a second capture opened beside the worker's"
    assert not isinstance(pdisp._fns[psig], _Graph)
    gate2, _, _ = _gated_worker_capture(ex2, rq2)   # another executor
    gate.go.set()
    inline.join(120.0)
    assert not inline.is_alive()
    assert ex.precompile_quiesce(120.0)
    assert not gc.isenabled()             # ex2's capture is still open
    gate2.go.set()
    assert ex2.precompile_quiesce(120.0)
    assert gc.isenabled()
    assert isinstance(pdisp._fns[psig], _Graph)
    assert isinstance(disp._fns[sig], _Graph)
    disp.fn = gate.fn
    assert torch.equal(ex.run(*pq), eager.run(*pq))
    assert torch.equal(ex.run(*rq), eager.run(*rq))
    assert ex.async_capture_errors == ex2.async_capture_errors == 0
    for e in (ex, ex2):
        e.stop_precompiler()


def test_gpu_release_and_stop_during_worker_capture(cuda):
    """release() while the worker's capture is open waits for it, drops
    every program and installs nothing the worker captured; once the
    allocator's cache is emptied the old pool holds no memory. Then
    stop_precompiler() while a capture is open joins the worker after
    it, with that graph installed; nothing crashes."""
    from repro_torch.core.executor import _Graph
    ex, eager, pq, rq = _worker_case(cuda)
    gate, disp, sig = _gated_worker_capture(ex, rq)
    pool = ex._pool
    assert pool is not None
    th = threading.Thread(target=ex.release)
    th.start()
    th.join(0.5)
    assert th.is_alive(), "release() emptied the cache under a capture"
    gate.go.set()
    th.join(120.0)
    assert not th.is_alive()
    assert ex.precompile_quiesce(120.0)
    assert ex.cache_keys() == [] and graph_count(ex) == 0
    assert ex.async_capture_errors == 0
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    assert _pool_bytes(pool) == 0
    # stop during a capture: the worker finishes it first
    ex.stop_precompiler()
    gate, disp, sig = _gated_worker_capture(ex, rq)
    th = threading.Thread(target=ex.stop_precompiler)
    th.start()
    th.join(0.5)
    assert th.is_alive()
    gate.go.set()
    th.join(120.0)
    assert not th.is_alive() and not ex.precompiling
    assert isinstance(disp._fns[sig], _Graph)
    disp.fn = gate.fn
    assert torch.equal(ex.run(*rq), eager.run(*rq))
    ex.release()
    assert graph_count(ex) == 0


def test_gpu_scheduler_pads_to_a_captured_width(cuda):
    """Drain mode with the worker started by hand: an 8-wide point batch
    runs eagerly and is not warm until the worker captured it; then a
    3-request batch pads to the captured width 8 (a width fallback), and
    every ticket is bitwise its serial submit. The serving thread
    captures nothing while the worker runs."""
    sess, reqs, serial = _scheduler_case(cuda, 80)
    ex = sess.executor
    points = [i for i in range(len(reqs)) if isinstance(reqs[i][0],
                                                        T.PointQuery)]
    sched = sess.scheduler(start=False)
    assert not ex.precompiling
    assert ex.start_precompiler()
    serving_ms = ex.capture_ms["serving"]
    tickets = []
    for lo, hi in ((0, 8), (8, 16), (16, 19)):
        for i in points[lo:hi]:
            tickets.append((i, sched.submit(*reqs[i])))
        sched.drain()
        assert ex.precompile_quiesce(120.0)
    widths = [e[3] for e in sched.events if e[0] == "batch"]
    assert widths == [8, 8, 8], widths
    st = sched.stats()
    assert st["width_fallbacks"] == 1
    assert ex.capture_ms["serving"] == serving_ms
    assert ex.async_capture_errors == 0 and ex.async_compiles >= 2
    for i, t in tickets:
        assert _same_tree(t.result(), serial[i]), i
    sched.close()
    ex.stop_precompiler()


def test_gpu_scheduler_chunks_at_a_smaller_captured_width(cuda):
    """Drain mode with the worker started by hand, width 1 captured: a
    2-request point batch, whose width 2 is neither warm nor held by a
    larger warm width, runs as two width-1 replays (nothing eager at
    width 2 on the serving thread, a width fallback), bitwise its serial
    submits; once the worker captured width 2, the next such batch runs
    at it."""
    from repro_torch.core.executor import _Graph
    sess, reqs, serial = _scheduler_case(cuda, 40)
    ex = sess.executor
    points = [i for i in range(len(reqs)) if isinstance(reqs[i][0],
                                                        T.PointQuery)]
    disp = [d for k, d in ex._cache.items() if k[2] == ("point",)][0]
    sched = sess.scheduler(start=False)
    assert ex.start_precompiler()
    serving_ms = ex.capture_ms["serving"]
    tickets = []
    for lo, hi in ((0, 1), (1, 3)):
        for i in points[lo:hi]:
            tickets.append((i, sched.submit(*reqs[i])))
        sched.drain()
    width2 = [sg for sg in disp._fns if sg[0][0] == (2,)]
    assert all(isinstance(disp._fns[sg], _Graph) for sg in width2)
    assert ex.precompile_quiesce(120.0)
    for i in points[3:5]:
        tickets.append((i, sched.submit(*reqs[i])))
    sched.drain()
    widths = [e[3] for e in sched.events if e[0] == "batch"]
    assert widths == [1, 2, 2], widths
    assert sched.stats()["width_fallbacks"] == 1
    assert ex.capture_ms["serving"] == serving_ms
    assert ex.async_capture_errors == 0
    for i, t in tickets:
        assert _same_tree(t.result(), serial[i]), i
    sched.close()
    ex.stop_precompiler()


# -- the point kernel on a shard, and the meshed engine at world size 1 --

def shard_point_args(args, kw, off: int, p_loc: int):
    """``point_query``'s arguments (``point_args``) for the shard of
    partitions [off, off + p_loc): the planes' rows, the boxes whole."""
    sliced = [args[0]] + [a[off:off + p_loc].contiguous() for a in args[1:7]]
    return sliced + list(args[7:]), dict(kw, part_offset=off)


@pytest.mark.parametrize("off,p_loc", [(0, 4), (4, 4), (2, 5), (7, 1)])
def test_gpu_point_query_on_a_shard_matches_plain(index, cuda, off, p_loc):
    """The point kernel on a shard (``part_offset`` > 0 included) bitwise
    its plain version with the same offset, on the card and on the CPU;
    the shards' flags OR-ed give the unsharded answer."""
    x, y, idx = index
    ex = SpatialEngine(idx, device="cpu").executor
    rng = np.random.default_rng(off)
    ix = rng.integers(0, len(x), 600)
    qx = np.concatenate([x[ix], rng.random(200).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(200).astype(np.float32)])
    args, kw = point_args(ex, qx, qy, cuda)
    sargs, skw = shard_point_args(args, kw, off, p_loc)
    n0 = t_pp.launches
    got = t_pp.point_query(*sargs, **skw)
    assert t_pp.launches == n0 + 1
    assert torch.equal(got, t_pp.point_query_plain(*sargs, **skw))
    cpu = [a.cpu() for a in sargs]
    assert torch.equal(got.cpu(), t_pp.point_query(*cpu, **skw))
    p = args[3].shape[0]
    union = torch.zeros_like(got)
    for lo in range(0, p, p_loc):
        a, k = shard_point_args(args, kw, lo, min(p_loc, p - lo))
        union |= t_pp.point_query(*a, **k)
    assert torch.equal(union, t_pp.point_query(*args, **kw))


def mesh_calls(qx, qy, rects, r, polys, ne, k: int = 10) -> dict:
    """name -> call on an engine: every read family, strict (the
    facade) and serving (``run``, strict=False)."""
    return {
        "point": lambda e: e.point_query(qx, qy),
        "range_count": lambda e: e.range_count(rects),
        "range_query": lambda e: e.range_query(rects),
        "circle_count": lambda e: e.circle_count(qx, qy, r),
        "circle_query": lambda e: e.circle_query(qx, qy, r),
        "knn_pruned": lambda e: e.knn(qx, qy, k),
        "knn_exact": lambda e: e.knn(qx, qy, k, "exact"),
        "join_windowed": lambda e: e.join_count(polys, ne),
        "join_full": lambda e: e.join_count(polys, ne, mode="full"),
        "serve_range_query": lambda e: e.run(T.RangeQuery(), rects),
        "serve_circle_count": lambda e: e.run(T.CircleQuery(), qx, qy, r),
        "serve_circle_query": lambda e: e.run(
            T.CircleQuery(materialize=True), qx, qy, r),
        "serve_knn": lambda e: e.run(T.Knn(k=k), qx, qy),
        "serve_join": lambda e: e.run(T.SpatialJoin(), polys, ne),
    }


def meshed_match(got, want) -> str:
    """How a meshed result equals the unmeshed one: "bitwise", or by
    DESIGN.md §10's compaction rule ("compaction": counts, flags and kNN
    distances bitwise, materialized ids equal as sets where ok, kNN ids
    equal up to the order of equal distances), else ""."""
    if _same(got, want):
        return "bitwise"
    got, want = _tup(got), _tup(want)
    if len(got) == 3:                           # (counts, vids, ok)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2],
                                                              want[2])):
            return ""
        ok = got[2].tolist()
        sg = [set(v for v in row if v >= 0) for row in got[1].tolist()]
        sw = [set(v for v in row if v >= 0) for row in want[1].tolist()]
        return "compaction" if all(a == b for a, b, o in zip(sg, sw, ok)
                                   if o) else ""
    if len(got) == 2 and got[0].dtype == torch.float32:     # kNN
        if not torch.equal(got[0], want[0]):
            return ""
        pair = [torch.sort(v[1].to(torch.int64) + (v[0].view(
            torch.int32).to(torch.int64) << 32), 1).values for v in (got,
                                                                   want)]
        return "compaction" if torch.equal(*pair) else ""
    return ""


def world1_mesh_check(n_points: int = 1 << 15, n_parts: int = 32,
                      store: str = None) -> dict:
    """The meshed engines at world size 1, NCCL, in this process (which
    must not have a process group yet): a (1,) partition mesh and a
    (1, 1) partition x query mesh whose threshold (16) puts every batch
    here on the query axis, each family three times (eager, captured,
    replayed) against the unmeshed engine's third call; the collectives
    per replayed call; a serving round under sync-debug "error"."""
    import tempfile

    from repro_torch.launch import mesh as M
    if store is None:
        store = os.path.join(tempfile.mkdtemp(), "store")
    dev = M.init_process("cuda", init_method=f"file://{store}",
                         world_size=1, rank=0)
    x, y = ds.make("taxi", n_points, seed=4)
    part = fit("kdtree", x, y, n_parts, seed=0)
    idx = build_index(x, y, part, device=dev)
    rng = np.random.default_rng(5)
    ix = rng.integers(0, len(x), 256)
    qx = torch.as_tensor(x[ix], device=dev)
    qy = torch.as_tensor(y[ix], device=dev)
    rects = torch.as_tensor(ds.random_rects(256, 1e-4, part.bounds, seed=6,
                                            centers=(x, y)), device=dev)
    r = torch.full((256,), 0.005, device=dev)
    polys, ne = ds.random_polygons(32, part.bounds, seed=7)
    polys, ne = torch.as_tensor(polys, device=dev), torch.as_tensor(
        ne, device=dev)
    calls = mesh_calls(qx, qy, rects, r, polys, ne)
    plain = SpatialEngine(idx, device=dev)
    meshed = {
        "part": SpatialEngine(idx, device=dev, mesh=M.make_host_mesh(
            (1,), ("data",), device=dev), part_axis="data"),
        "part_query": SpatialEngine(
            idx, EngineConfig(query_shard_threshold=16), device=dev,
            mesh=M.make_host_mesh((1, 1), ("data", "query"), device=dev),
            part_axis="data", query_axis="query"),
    }
    report = {"match": {}, "collectives": {}}
    want = {}
    for name, fn in calls.items():
        for _ in range(3):
            want[name] = fn(plain)
    for tag, eng in meshed.items():
        for name, fn in calls.items():
            for i in range(3):
                m0 = M.launches
                got = fn(eng)
                report["match"][f"{tag}/{name}/{i}"] = meshed_match(
                    got, want[name])
            report["collectives"][f"{tag}/{name}"] = M.launches - m0
        ex = eng.executor
        report[f"{tag}/graphs"] = graph_count(ex)
        report[f"{tag}/qshard_executables"] = \
            ex.stats()["qshard_executables"]
        # a narrow serving round (16 rows: no bucketed probe read),
        # realized twice, then replayed under sync-debug "error"
        narrow = [fn for name, fn in mesh_calls(
            qx[:16], qy[:16], rects[:16], r[:16], polys[:4],
            ne[:4]).items() if name.startswith("serve_")]
        for _ in range(2):
            for fn in narrow:
                fn(eng)
        h = ex.host_syncs
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for fn in narrow:
                fn(eng)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        report[f"{tag}/serving_host_syncs"] = ex.host_syncs - h
    import torch.distributed as dist
    dist.destroy_process_group()
    return report


def test_gpu_meshed_engine_at_world_size_one(cuda, tmp_path):
    """A world-size-1 NCCL group in a subprocess: every family, strict
    and serving, through the meshed engines' CUDA graphs, bitwise the
    unmeshed engine; every collective issued (counted on each replay);
    the query-axis wrappings cached; a serving round makes no host
    sync."""
    import subprocess
    import sys
    code = ("import json, sys; sys.path[:0] = ['tests', 'src']\n"
            "import test_torch_gpu as G\n"
            f"r = G.world1_mesh_check(store={str(tmp_path / 's')!r})\n"
            "print('REPORT ' + json.dumps(r))\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("REPORT ")]
    rep = json.loads(line[-1][len("REPORT "):])
    assert all(v == "bitwise" for v in rep["match"].values()), rep["match"]
    assert all(n > 0 for n in rep["collectives"].values()), rep
    for tag in ("part", "part_query"):
        assert rep[f"{tag}/graphs"] > 0
        assert rep[f"{tag}/serving_host_syncs"] == 0
    assert rep["part/qshard_executables"] == 0
    assert rep["part_query/qshard_executables"] > 0
