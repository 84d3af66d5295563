"""Port parity of the kernels' plain versions.

Each kernel's plain PyTorch version (what the wrapper runs on CPU
tensors, and what the kernel is held against on the card) is checked
bitwise against the JAX package's oracle (``kernels/ref.py``), and
range_count, circle_count, point_probe, knn_topk and morton also
against the Pallas kernel in interpret mode. ``spline_search``'s Pallas kernel
cannot run on this jax (``pl.load`` is gone), so it is checked against
``ref.spline_search``; ``point_in_polygon``'s is in
``tests/test_torch_join.py``, against ``ref.point_in_polygon``.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build, fit as j_fit
from repro.core import keys as JK
from repro.core import local_ops as JL
from repro.data import spatial as jds
from repro.kernels import ops, ref
from repro_torch import kernels as TKERN
from repro_torch.core import keys as TK
from repro_torch.kernels import circle_filter as t_cf
from repro_torch.kernels import knn_topk as t_knn
from repro_torch.kernels import morton as t_mo
from repro_torch.kernels import point_in_polygon as t_pip
from repro_torch.kernels import point_probe as t_pp
from repro_torch.kernels import range_filter as t_rf
from repro_torch.kernels import spline_search as t_ss
from test_torch_gpu import INTERVAL_KINDS, polygon_set, skewed_intervals

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

# the oracles as the engine runs them: compiled, where XLA:CPU contracts
# dx*dx + dy*dy and p0 + t*(p1 - p0) into FMAs (eager jax does not)
ref_spline_search = jax.jit(ref.spline_search,
                            static_argnames=("probe", "radix_bits"))
ref_knn_topk = jax.jit(ref.knn_topk, static_argnames=("k",))
ref_circle_count = jax.jit(ref.circle_count)


@pytest.fixture(scope="module")
def jidx():
    """A JAX index with duplicate points (ties, long key runs), partitions
    below n_pad, and two empty padding partitions."""
    x, y = jds.make("taxi", 5000, seed=3)
    rng = np.random.default_rng(0)
    dup = rng.integers(0, 5000, 600)
    x = np.concatenate([x, x[dup]])
    y = np.concatenate([y, y[dup]])
    idx = j_build(x, y, j_fit("kdtree", x, y, 6, seed=0))
    return x, y, JL.pad_partitions(idx, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _query_keys(idx, rng, nq):
    kf = np.asarray(JK.keys_to_f32(idx.key))
    cnt = np.asarray(idx.count)
    sent = float(idx.key_spec.sentinel)
    data = kf[0, rng.integers(0, cnt[0], nq // 2)]
    rand = rng.integers(0, 1 << 22, nq - nq // 2 - 6).astype(np.float32)
    edge = np.asarray([0, 1, sent - 1, sent, sent + 1, kf[1, cnt[1] - 1]],
                      np.float32)
    return np.concatenate([data, rand, edge]).astype(np.float32)


@pytest.mark.parametrize("nq", [20, 300])
def test_spline_search_plain_vs_ref(jidx, nq):
    _, _, idx = jidx
    rng = np.random.default_rng(nq)
    q = _query_keys(idx, rng, nq)
    keys_f = np.asarray(JK.keys_to_f32(idx.key))
    kw = dict(probe=idx.probe, radix_bits=idx.radix_bits)
    got = t_ss.spline_search(
        _t(q), _t(idx.knot_keys), _t(idx.knot_pos), _t(idx.radix_table),
        _t(keys_f), _t(idx.radix_kmin), _t(idx.radix_scale),
        _t(idx.n_knots), _t(idx.count), **kw).numpy()
    assert got.shape == (idx.num_partitions, len(q))
    for p in range(idx.num_partitions):
        want = np.asarray(ref_spline_search(
            jnp.asarray(q), idx.knot_keys[p], idx.knot_pos[p],
            idx.radix_table[p], keys_f[p], idx.radix_kmin[p],
            idx.radix_scale[p], idx.n_knots[p], idx.count[p], **kw))
        assert np.array_equal(got[p], want), p
        c = int(idx.count[p])
        assert np.array_equal(got[p], np.searchsorted(keys_f[p, :c], q))


def _range_inputs(idx, nq, seed):
    rng = np.random.default_rng(seed)
    rects = jds.random_rects(nq, 3e-2, (0, 0, 1, 1), seed=seed)
    c, n_pad = idx.num_partitions, idx.n_pad
    s = rng.integers(0, n_pad, (c, nq)).astype(np.int32)
    e = (s + rng.integers(-50, n_pad, (c, nq))).astype(np.int32)
    s[:, 0], e[:, 0] = 0, n_pad                 # the whole row
    e = np.minimum(e, n_pad + 64)               # e may pass n_pad
    active = rng.random((c, nq)) < 0.7
    return rects, s, e, active


@pytest.mark.parametrize("nq", [3, 129])
def test_range_count_plain_vs_ref_and_pallas(jidx, nq):
    _, _, idx = jidx
    rects, s, e, active = _range_inputs(idx, nq, nq)
    got = t_rf.range_count(_t(rects), _t(s), _t(e), _t(active),
                           _t(idx.count), _t(idx.x), _t(idx.y)).numpy()
    assert got.dtype == np.int32 and got.sum() > 0
    for p in range(idx.num_partitions):
        se = jnp.asarray(np.stack([s[p], e[p]], 1), jnp.float32)
        args = (jnp.asarray(rects), se, idx.count[p], idx.x[p], idx.y[p])
        want = np.asarray(ref.range_count(*args))
        pallas = np.asarray(ops.range_count(*args, interpret=True))
        assert np.array_equal(want, pallas)
        assert np.array_equal(got[p], np.where(active[p], want, 0)), p


@pytest.mark.parametrize("nq", [3, 129])
def test_circle_count_plain_vs_ref_and_pallas(jidx, nq):
    """Circles on data points (r = 0 included), their MBRs, random
    learned bounds and active flags."""
    x, y, idx = jidx
    _, s, e, active = _range_inputs(idx, nq, nq + 7)
    rng = np.random.default_rng(nq)
    ix = rng.integers(0, len(x), nq)
    cx, cy = x[ix].copy(), y[ix].copy()
    r = rng.uniform(0, 0.08, nq).astype(np.float32)
    r[0] = 0.0
    rects = np.stack([cx - r, cy - r, cx + r, cy + r], 1).astype(np.float32)
    circ = np.stack([cx, cy, r], 1).astype(np.float32)
    got = t_cf.circle_count(_t(rects), _t(s), _t(e), _t(circ), _t(active),
                            _t(idx.count), _t(idx.x), _t(idx.y)).numpy()
    assert got.dtype == np.int32 and got.sum() > 0
    for p in range(idx.num_partitions):
        se = jnp.asarray(np.stack([s[p], e[p]], 1), jnp.float32)
        args = (jnp.asarray(rects), se, jnp.asarray(circ), idx.count[p],
                idx.x[p], idx.y[p])
        want = np.asarray(ref_circle_count(*args))
        pallas = np.asarray(ops.circle_count(*args, interpret=True))
        assert np.array_equal(want, pallas)
        assert np.array_equal(got[p], np.where(active[p], want, 0)), p


def _point_inputs(idx, nq, seed):
    """Queries on real points (some duplicated), misses, and windows at
    both ends of the row."""
    rng = np.random.default_rng(seed)
    p_tot, n_pad, probe = idx.num_partitions, idx.n_pad, idx.probe
    cnt = np.asarray(idx.count)
    pid = rng.integers(0, 6, nq).astype(np.int32)
    pos = (rng.random(nq) * cnt[pid]).astype(np.int64)
    keys_f = np.asarray(JK.keys_to_f32(idx.key))
    px, py = np.asarray(idx.x), np.asarray(idx.y)
    qk, qx, qy = keys_f[pid, pos], px[pid, pos].copy(), py[pid, pos].copy()
    qx[rng.random(nq) < 0.3] += 1e-3            # misses
    start = np.clip(pos - probe // 2, 0, n_pad - probe).astype(np.int32)
    start[0], start[-1] = 0, n_pad - probe      # both ends of the row
    pid[-1] = p_tot - 1                         # an empty padding row
    return pid, start, qk, qx, qy


@pytest.mark.parametrize("nq", [2, 150])
def test_point_probe_plain_vs_ref_and_pallas(jidx, nq):
    _, _, idx = jidx
    pid, start, qk, qx, qy = _point_inputs(idx, nq, nq)
    keys_f = np.asarray(JK.keys_to_f32(idx.key))
    probe = idx.probe
    got = t_pp.point_probe_plain(_t(pid), _t(start), _t(qk), _t(qx),
                                 _t(qy), _t(keys_f), _t(idx.x), _t(idx.y),
                                 probe=probe).numpy()
    lanes = start[:, None] + np.arange(probe)[None, :]
    win = [jnp.asarray(np.asarray(a)[pid[:, None], lanes])
           for a in (keys_f, idx.x, idx.y)]
    qargs = (jnp.asarray(qk), jnp.asarray(qx), jnp.asarray(qy))
    want = np.asarray(ref.point_probe(*qargs, *win, probe=probe))
    pallas = np.asarray(ops.point_probe(*qargs, *win, probe=probe,
                                        interpret=True))
    assert np.array_equal(got, want) and np.array_equal(want, pallas)
    assert (got > 1).any() or nq < 100         # duplicates counted


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("nq", [4, 130])
def test_knn_topk_plain_vs_ref_and_pallas(jidx, k, nq):
    x, y, idx = jidx
    rng = np.random.default_rng(k * 7 + nq)
    ix = rng.integers(0, len(x), nq)
    qx, qy = x[ix].copy(), y[ix].copy()
    qx[::3] += np.float32(1e-4)
    gn, gi = t_knn.knn_topk(_t(qx), _t(qy), _t(idx.count), _t(idx.x),
                            _t(idx.y), k=k)
    gn, gi = gn.numpy(), gi.numpy()
    assert gn.shape == gi.shape == (idx.num_partitions, nq, k)
    qxy = jnp.asarray(np.stack([qx, qy], 1))
    for p in range(idx.num_partitions):
        wn, wi = ref_knn_topk(qxy, idx.count[p], idx.x[p], idx.y[p], k=k)
        assert np.array_equal(gn[p], np.asarray(wn)), p
        assert np.array_equal(gi[p], np.asarray(wi)), p
        if p in (0, idx.num_partitions - 1):    # a full and an empty row
            pn, pi = ops.knn_topk(qxy, idx.count[p], idx.x[p], idx.y[p],
                                  k=k, interpret=True)
            assert np.array_equal(gn[p], np.asarray(pn)), p
            assert np.array_equal(gi[p], np.asarray(pi)), p
    assert (gi[-1] == -1).all() and (gn[-1] == np.float32(-3e38)).all()


def test_knn_topk_tie_order_lowest_position():
    x = torch.tensor([[0.5, 0.3, 0.7, 0.5, 0.5, 0.3, 9.0]], dtype=torch.float32)
    y = torch.tensor([[0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 9.0]], dtype=torch.float32)
    neg, idx = t_knn.knn_topk(torch.tensor([0.5]), torch.tensor([0.5]),
                              torch.tensor([6], dtype=torch.int32), x, y,
                              k=6)
    assert idx[0, 0].tolist() == [0, 3, 4, 1, 2, 5]


def _knn_by_slices(qx, qy, count, x, y, k, slices):
    """knn_topk_plain over ``slices`` slices of each row, merged by
    (d^2, position) lexicographically: the decomposition csrc/knn_topk.cu
    launches, each slice's list being its top-k and the merge a top-k of
    the lists."""
    c, n_pad = x.shape
    step = -(-n_pad // slices)
    d_all, p_all = [], []
    for lo in range(0, n_pad, step):
        hi = min(lo + step, n_pad)
        cnt = torch.clamp(count - lo, 0, hi - lo).to(torch.int32)
        neg, idx = t_knn.knn_topk_plain(qx, qy, cnt,
                                        x[:, lo:hi].contiguous(),
                                        y[:, lo:hi].contiguous(), k=k)
        hit = idx >= 0
        d_all.append(torch.where(hit, -neg, float("inf")).double())
        p_all.append(torch.where(hit, idx + lo, 2 ** 31 - 1).long())
    d, p = torch.cat(d_all, -1), torch.cat(p_all, -1)
    # lexicographic (d^2, position): sort by position, then stably by d^2
    order = torch.argsort(p, dim=-1, stable=True)
    d, p = torch.gather(d, -1, order), torch.gather(p, -1, order)
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    d, p = torch.gather(d, -1, order), torch.gather(p, -1, order)
    hit = p < 2 ** 31 - 1
    return (torch.where(hit, -d, t_knn.NEG).float(),
            torch.where(hit, p, -1).to(torch.int32))


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("slices", [1, 3, 7])
def test_knn_topk_slice_merge_is_exact(slices, k):
    """The kernel's split of the point axis: the top-k of each slice,
    merged by (d^2, position), is knn_topk_plain's and the JAX oracle's
    top-k, with equal distances straddling every slice border, a row
    with count < k, and an empty row."""
    rng = np.random.default_rng(slices * 31 + k)
    c, n_pad, nq = 4, 700, 6
    step = -(-n_pad // slices)
    x = rng.random((c, n_pad)).astype(np.float32)
    y = rng.random((c, n_pad)).astype(np.float32)
    for b in range(step, n_pad, step):        # ties across each border
        x[:, b - 2:b + 2], y[:, b - 2:b + 2] = np.float32(0.4), np.float32(0.6)
    x[:, 5::97], y[:, 5::97] = np.float32(0.4), np.float32(0.6)
    count = np.asarray([n_pad, 451, k - 1, 0], np.int32)
    qx = rng.random(nq).astype(np.float32)
    qy = rng.random(nq).astype(np.float32)
    qx[:3], qy[:3] = np.float32(0.4), np.float32(0.6)
    qx[3], qy[3] = np.float32(0.4001), np.float32(0.6)
    args = tuple(map(_t, (qx, qy, count, x, y)))
    gn, gi = _knn_by_slices(*args, k=k, slices=slices)
    wn, wi = t_knn.knn_topk_plain(*args, k=k)
    assert torch.equal(gn, wn) and torch.equal(gi, wi)
    qxy = jnp.asarray(np.stack([qx, qy], 1))
    for p in range(c):
        rn, ri = ref_knn_topk(qxy, count[p], x[p], y[p], k=k)
        assert np.array_equal(gn[p].numpy(), np.asarray(rn)), p
        assert np.array_equal(gi[p].numpy(), np.asarray(ri)), p
    # the queries on the tie spot take the tied points lowest first
    tied = np.flatnonzero((x[0] == np.float32(0.4)) &
                          (y[0] == np.float32(0.6)))[:k]
    assert (gi[0, :3, :len(tied)].numpy() == tied[None, :]).all()
    assert (gi[2, :, max(k - 1, 0):] == -1).all() and (gi[3] == -1).all()


def _counts_by_shares(hit, s, e, active, count, n_pad, grid, tile):
    """csrc/interval_scan.cuh's split, in numpy. Phase 1: block b zeroes
    the outputs of its slice of ceil(n / grid) pairs and sums their
    lengths. Phase 2: the active intervals' positions, laid end to end,
    are cut into ``grid`` equal shares; each block scans the pairs of
    the slices that hold its share, in tiles of ``tile``, and adds each
    pair's hits in its share to the pair's output. ``hit(pairs,
    positions)`` tests points. Returns the (C, Q) counts and the (pair,
    position) of every scanned position; checks that every output is
    zeroed exactly once."""
    c, nq = s.shape
    n = c * nq
    lo = np.maximum(s, 0).reshape(-1).astype(np.int64)
    hi = np.minimum(np.minimum(e, count[:, None]), n_pad).reshape(-1)
    ln = np.where(active.reshape(-1), np.maximum(hi - lo, 0), 0)
    per = -(-n // grid)
    zeroed = np.zeros(n, np.int64)
    slice_total = np.zeros(grid, np.int64)
    for b in range(grid):
        p0 = min(b * per, n)
        p1 = min(p0 + per, n)
        zeroed[p0:p1] += 1
        slice_total[b] = ln[p0:p1].sum()
    assert (zeroed == 1).all()
    soff = np.concatenate([[0], np.cumsum(slice_total)])
    total = int(soff[-1])
    share = -(-total // grid)
    out = np.zeros(n, np.int64)
    seen = [np.zeros((0, 2), np.int64)]
    for b in range(grid):
        a = min(b * share, total)
        z = min(a + share, total)
        if a == z:
            continue
        first = int(np.searchsorted(soff[1:], a, side="right"))
        last = int(np.searchsorted(soff, z - 1, side="right")) - 1
        q1 = min((last + 1) * per, n)
        base, t0 = int(soff[first]), first * per
        while t0 < q1 and base < z:
            tl = ln[t0:min(t0 + tile, q1)]
            incl = base + np.cumsum(tl)
            v = np.arange(max(a, base), min(z, base + int(tl.sum())))
            j = np.searchsorted(incl, v, side="right")
            start = np.concatenate([[base], incl])[j]
            pos = lo[t0 + j] + (v - start)
            seen.append(np.stack([t0 + j, pos], 1))
            np.add.at(out, t0 + j, hit(t0 + j, pos))
            base += int(tl.sum())
            t0 += tile
    return out.reshape(c, nq), np.concatenate(seen)


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("nq", [0, 1, 16])
@pytest.mark.parametrize("kind", INTERVAL_KINDS)
def test_interval_split_covers_each_position_once(kind, nq, c):
    """The balanced split of range_count and circle_count (mirrored from
    csrc/interval_scan.cuh at an H100's grid of 132 blocks and 2,048
    pairs per tile, and at 5 blocks and 4 pairs per tile): it scans
    every position of every active interval exactly once, and its
    per-pair sums are range_count_plain's and circle_count_plain's."""
    from repro_torch._num import fma_f32

    n_pad = 600
    rng = np.random.default_rng(nq * 10 + c)
    x = rng.random((c, n_pad)).astype(np.float32)
    y = rng.random((c, n_pad)).astype(np.float32)
    cx = rng.random(nq).astype(np.float32)
    cy = rng.random(nq).astype(np.float32)
    r = rng.uniform(0.1, 0.6, nq).astype(np.float32)
    rects = np.stack([cx - r, cy - r, cx + r, cy + r], 1).astype(np.float32)
    rects[::3] = [0.0, 0.0, 1.0, 1.0]            # every point
    circ = np.stack([cx, cy, r], 1).astype(np.float32)
    xt, yt = _t(x), _t(y)

    def gather(i, pos):
        i = torch.from_numpy(i)
        pos = torch.from_numpy(pos.astype(np.int64))
        return xt[i // nq, pos], yt[i // nq, pos], i % nq

    def in_rect(i, pos):
        px, py, q = gather(i, pos)
        rq = _t(rects)[q]
        return ((px >= rq[:, 0]) & (px <= rq[:, 2]) &
                (py >= rq[:, 1]) & (py <= rq[:, 3]))

    def in_circle(i, pos):
        px, py, q = gather(i, pos)
        cq = _t(circ)[q]
        dx, dy = px - cq[:, 0], py - cq[:, 1]
        near = fma_f32(dx, dx, dy * dy) <= cq[:, 2] * cq[:, 2]
        return (in_rect(i, pos) & near).numpy().astype(np.int64)

    for grid, tile in ((132, 2048), (5, 4)):
        s, e, active, count = skewed_intervals(kind, c, nq, n_pad, grid,
                                               seed=grid + nq + c)
        args = tuple(map(_t, (s, e, active, count)))
        lo = np.maximum(s, 0).reshape(-1)
        hi = np.minimum(np.minimum(e, count[:, None]), n_pad).reshape(-1)
        want = [(i, p) for i in range(c * nq) if active.flat[i]
                for p in range(lo[i], hi[i])]
        got, seen = _counts_by_shares(
            lambda i, p: in_rect(i, p).numpy().astype(np.int64), s, e,
            active, count, n_pad, grid, tile)
        seen = seen[np.lexsort((seen[:, 1], seen[:, 0]))]
        assert np.array_equal(seen, np.asarray(want, np.int64).reshape(-1, 2))
        plain = t_rf.range_count_plain(_t(rects), args[0], args[1],
                                       args[2], args[3], xt, yt)
        assert np.array_equal(got, plain.numpy())
        got, _ = _counts_by_shares(in_circle, s, e, active, count, n_pad,
                                   grid, tile)
        plain = t_cf.circle_count_plain(_t(rects), args[0], args[1],
                                        _t(circ), args[2], args[3], xt, yt)
        assert np.array_equal(got, plain.numpy())
        if kind in ("one_row", "all_rows") and nq:
            assert plain.sum() > 0


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("nq", [0, 1, 4, 16])
@pytest.mark.parametrize("kind", INTERVAL_KINDS)
def test_interval_split_join_covers_each_position_once(kind, nq, c):
    """The same split for join_count (csrc/point_in_polygon.cu on
    csrc/interval_scan.cuh) at both grids and tiles, with the degenerate
    polygons (concave with horizontal edges, sliver, single vertex, no
    edges) first: every position of every active interval is scanned
    exactly once, and the per-pair sums of the hit test (the MBR, then
    point_in_polygon_plain) are join_count_plain's."""
    n_pad = 600
    rng = np.random.default_rng(nq * 10 + c + 1)
    x = rng.random((c, n_pad)).astype(np.float32)
    y = rng.random((c, n_pad)).astype(np.float32)
    polys, ne, mbrs = polygon_set(nq, seed=nq + c)
    xt, yt = _t(x), _t(y)
    pt, net, mt = _t(polys), _t(ne), _t(mbrs)

    def in_polygon(i, pos):
        i = torch.from_numpy(i)
        pos = torch.from_numpy(pos.astype(np.int64))
        px, py, g = xt[i // nq, pos], yt[i // nq, pos], i % nq
        m = mt[g]
        in_mbr = ((px >= m[:, 0]) & (px <= m[:, 2]) &
                  (py >= m[:, 1]) & (py <= m[:, 3]))
        inside = t_pip.point_in_polygon_plain(px[:, None], py[:, None],
                                              pt[g], net[g])[:, 0]
        return (in_mbr & inside).numpy().astype(np.int64)

    for grid, tile in ((132, 2048), (5, 4)):
        s, e, active, count = skewed_intervals(kind, c, nq, n_pad, grid,
                                               seed=grid + nq + c)
        lo = np.maximum(s, 0).reshape(-1)
        hi = np.minimum(np.minimum(e, count[:, None]), n_pad).reshape(-1)
        want = [(i, p) for i in range(c * nq) if active.flat[i]
                for p in range(lo[i], hi[i])]
        got, seen = _counts_by_shares(in_polygon, s, e, active, count,
                                      n_pad, grid, tile)
        seen = seen[np.lexsort((seen[:, 1], seen[:, 0]))]
        assert np.array_equal(seen, np.asarray(want, np.int64).reshape(-1, 2))
        plain = t_pip.join_count_plain(pt, net, mt, *map(_t, (s, e, active,
                                                             count)), xt, yt)
        assert np.array_equal(got, plain.numpy())
        if kind in ("one_row", "all_rows") and nq:
            assert plain.sum() > 0


@pytest.mark.parametrize("n", [1, 7, 1000, 3001])
def test_morton_plain_vs_ref_and_pallas(n):
    """The morton kernel's plain version (int64 in and out) against the
    Pallas kernel in interpret mode and ``ref.morton_encode`` (uint32),
    on sizes that are no multiple of its (8, 128) block, with the edge
    values 0, 0xFFFF, 2^16 and 0xFFFFFFFF and full-range uint32."""
    rng = np.random.default_rng(n)
    qx = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    qy = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    edge = np.asarray([0, 0xFFFF, 1 << 16, 0xFFFFFFFF], np.uint32)
    qx[:4], qy[-4:] = edge[:n], edge[::-1][:n]
    got = t_mo.morton_encode(_t(qx.astype(np.int64)),
                             _t(qy.astype(np.int64)))
    assert got.dtype == torch.int64 and got.shape == (n,)
    pallas = ops.morton_encode(jnp.asarray(qx), jnp.asarray(qy),
                               interpret=True)
    oracle = ref.morton_encode(jnp.asarray(qx), jnp.asarray(qy))
    for want in (pallas, oracle):
        assert np.asarray(want).dtype == np.uint32
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # 16-bit coordinates: the index build's key step, core/keys.py
    lo = (_t(qx.astype(np.int64)) & 0xFFFF, _t(qy.astype(np.int64)) & 0xFFFF)
    assert torch.equal(t_mo.morton_encode(*lo), TK.morton_encode(*lo))


def test_cpu_wrappers_never_count_launches(jidx):
    _, _, idx = jidx
    TKERN.reset_launch_counts()
    t_knn.knn_topk(_t(idx.x[0, :3]), _t(idx.y[0, :3]), _t(idx.count),
                   _t(idx.x), _t(idx.y), k=2)
    assert TKERN.launch_counts() == {n: 0 for n in TKERN.KERNELS}


def test_wrappers_reject_mixed_devices(jidx):
    _, _, idx = jidx
    with pytest.raises(ValueError):
        t_knn.knn_topk(_t(idx.x[0, :3]), _t(idx.y[0, :3]),
                       _t(idx.count).to("meta"), _t(idx.x), _t(idx.y), k=2)



def test_filter_mask_matches_xla_backend(jidx):
    """TorchBackend.filter_mask (the range_count kernel's mask) against
    the JAX package's XlaBackend.filter_mask, partition by partition."""
    from repro.core.backends import XlaBackend
    from repro_torch.core.backends import TorchBackend

    _, _, idx = jidx
    rects, s, e, active = _range_inputs(idx, 40, 4)
    ch = {"count": _t(idx.count), "x": _t(idx.x), "y": _t(idx.y)}
    got = TorchBackend().filter_mask(ch, _t(rects), _t(s), _t(e),
                                     _t(active)).numpy()
    keys_f = JK.keys_to_f32(idx.key)
    for p in range(idx.num_partitions):
        part = {"keys_f": keys_f[p], "count": idx.count[p], "x": idx.x[p],
                "y": idx.y[p]}
        want = XlaBackend().filter_mask(part, jnp.asarray(rects),
                                        jnp.asarray(s[p]), jnp.asarray(e[p]),
                                        jnp.asarray(active[p]))
        assert np.array_equal(got[p], np.asarray(want)), p


def test_geometry_helpers_bitwise(jidx):
    """The global filter's box tests and the kNN box distance, bitwise
    the JAX package's (jitted, where XLA:CPU contracts the distance)."""
    from repro.core import queries as JQ
    from repro_torch.core import queries as TQ

    x, y, idx = jidx
    boxes = np.asarray(idx.part_bounds)
    rng = np.random.default_rng(8)
    qx = np.concatenate([x[:50], rng.uniform(-0.5, 1.5, 50)]).astype(
        np.float32)
    qy = np.concatenate([y[:50], rng.uniform(-0.5, 1.5, 50)]).astype(
        np.float32)
    rects = jds.random_rects(64, 1e-2, (0, 0, 1, 1), seed=8)
    jb = jnp.asarray(boxes)
    assert np.array_equal(
        TQ.rect_overlaps_box(_t(rects), _t(boxes)).numpy(),
        np.asarray(JQ.rect_overlaps_box(jnp.asarray(rects), jb)))
    assert np.array_equal(
        TQ.point_in_box(_t(qx), _t(qy), _t(boxes)).numpy(),
        np.asarray(JQ.point_in_box(jnp.asarray(qx), jnp.asarray(qy), jb)))
    want = np.asarray(jax.jit(JQ.box_min_dist2)(qx, qy, jb))
    got = TQ.box_min_dist2(_t(qx), _t(qy), _t(boxes)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
