"""Port parity of the windowed query path: keys (z-split, Morton decode),
the windowed gathers, the candidate and compaction helpers, and the
windowed and circle programs, against the JAX package (``xla`` backend,
jitted as its engine runs them) on the same numpy-seeded inputs.

Every comparison is bitwise: counts, ids, squared distances, window
positions and ok flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import build_index as j_build, fit as j_fit
from repro.core import keys as JK
from repro.core import local_ops as JL
from repro.core import queries as JQ
from repro.core.backends import XlaBackend
from repro.data import spatial as jds
from repro_torch import convert
from repro_torch.core import EngineConfig, Executor, build_index, fit
from repro_torch.core import build as TB
from repro_torch.core import keys as TK
from repro_torch.core import local_ops as TL
from repro_torch.core import queries as TQ

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind == "f":
        return np.array_equal(got.view(np.int32), want.view(np.int32))
    return np.array_equal(got.astype(np.int64), want.astype(np.int64))


# -- keys -----------------------------------------------------------------

def _quant_rects(seed, n=3000, bits=11):
    """Quantized rect corners: random, zero width, one cell, the full
    domain, inverted, and corner cases at the top of the range."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    lo = rng.integers(0, top, (n, 2))
    hi = np.minimum(lo + rng.integers(0, 300, (n, 2)), top)
    lo[:6] = [[5, 5], [0, 0], [0, 0], [7, 9], [top, 0], [0, top]]
    hi[:6] = [[5, 5], [top, top], [0, 0], [7, 300], [top, top], [top, top]]
    lo[6], hi[6] = [40, 40], [10, 10]                 # inverted
    valid = rng.random(n) < 0.9
    return lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], valid


@pytest.mark.parametrize("depth", [2, 3])
def test_z_split_intervals_bitwise(depth):
    xl, yl, xh, yh, valid = _quant_rects(depth)
    want = JK.z_split_intervals(*(jnp.asarray(v, jnp.uint32)
                                  for v in (xl, yl, xh, yh)),
                                jnp.asarray(valid), depth=depth)
    got = TK.z_split_intervals(*map(_t, (xl, yl, xh, yh, valid)),
                               depth=depth)
    for g, w in zip(got, want):
        assert g.shape == (len(xl), 1 << depth)
        assert _eq(g, w)


@pytest.mark.parametrize("depth", [2, 3])
def test_morton_decode_bitwise(depth):
    """Morton decode of 32-bit keys and of the z-split pieces' ends."""
    rng = np.random.default_rng(depth)
    keys = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    keys[:3] = [0, (1 << 32) - 1, 0x55555555]
    jx, jy = JK.morton_decode(jnp.asarray(keys, jnp.uint32))
    tx, ty = TK.morton_decode(_t(keys.astype(np.int64)))
    assert _eq(tx, jx) and _eq(ty, jy)
    xl, yl, xh, yh, valid = _quant_rects(depth + 10, n=500)
    valid &= (xl <= xh) & (yl <= yh)
    zlo, zhi, pv = TK.z_split_intervals(*map(_t, (xl, yl, xh, yh, valid)),
                                        depth=depth)
    dx, dy = TK.morton_decode(zlo[pv])      # valid pieces start inside
    rows = pv.nonzero()[:, 0].numpy()
    assert (dx.numpy() >= xl[rows]).all() and (dy.numpy() >= yl[rows]).all()
    assert (dx.numpy() <= xh[rows]).all() and (dy.numpy() <= yh[rows]).all()


def test_data_bounds_and_compact_bits():
    x, y = jds.make("gaussian", 1000, seed=2)
    assert TK.data_bounds(x, y) == JK.data_bounds(x, y)
    v = np.random.default_rng(3).integers(0, 1 << 16, 2000)
    spread = TK.spread_bits(_t(v))
    assert _eq(TK.compact_bits(spread), v)


@pytest.mark.parametrize("box", [(0.2, 0.3, 0.6, 0.5), (0.0, 0.0, 1.0, 1.0),
                                 (0.9, 0.9, 0.95, 0.92)])
def test_clipped_key_range_bitwise(box):
    """Rects clipped to one partition box (empty intersections too) and
    the clipped rects' key ranges."""
    rects = jds.random_rects(300, 1e-2, (0, 0, 1, 1), seed=14)
    js, ts = JK.KeySpec(), TK.KeySpec()
    box_np = np.asarray(box, np.float32)
    want = JQ.clipped_key_range(jnp.asarray(rects), jnp.asarray(box_np), js)
    got = TQ.clipped_key_range(_t(rects), _t(box_np), ts)
    for g, w in zip(got, want):
        assert _eq(g, w)
    assert _eq(TQ.clip_rect_to_box(_t(rects), _t(box_np)),
               JQ.clip_rect_to_box(jnp.asarray(rects), jnp.asarray(box_np)))
    assert bool(got[2].any()) and (box[0] == 0.0 or not bool(got[2].all()))


# -- the windowed gathers and the helpers ---------------------------------

@pytest.fixture(scope="module")
def win():
    """A taxi index with duplicate points, built by both packages, padded
    to 8 partitions; port (parts, bounds) and JAX (parts, index)."""
    x, y = jds.make("taxi", 5000, seed=3)
    dup = np.random.default_rng(0).integers(0, 5000, 600)
    x = np.concatenate([x, x[dup]])
    y = np.concatenate([y, y[dup]])
    jidx = JL.pad_partitions(j_build(x, y, j_fit("kdtree", x, y, 6,
                                                 seed=0)), 8)
    ex = Executor(build_index(x, y, fit("kdtree", x, y, 6, seed=0),
                              device="cpu"), device="cpu")
    return x, y, ex, jidx, JL.part_arrays(jidx)


def _candidates(rects, bounds_np, cand, seed):
    overlap = np.asarray(JQ.rect_overlaps_box(jnp.asarray(rects),
                                              jnp.asarray(bounds_np)))
    pids, valid, _ = JL._top_candidates(jnp.asarray(overlap), cand)
    valid = np.asarray(valid) & (np.random.default_rng(seed).random(
        valid.shape) < 0.9)
    pids = np.asarray(pids)
    return pids, valid, bounds_np[pids]


def test_bounds_on_rows_bitwise(win):
    _, _, ex, jidx, jparts = win
    rng = np.random.default_rng(4)
    p = jidx.num_partitions
    pid = rng.integers(0, p, (40, 5)).astype(np.int32)
    kf = np.asarray(JK.keys_to_f32(jidx.key))
    cnt = np.asarray(jidx.count)
    qk = rng.integers(0, 1 << 22, (40, 5, 8)).astype(np.float32)
    data = kf[pid, (rng.random((40, 5)) * np.maximum(cnt[pid], 1)).astype(
        int) % kf.shape[1]]
    qk[..., 0] = data
    qk[..., 1] = data + 1
    qk[0, 0, :3] = [0, float(1 << 22), float(1 << 24)]
    want = jax.jit(JQ.bounds_on_rows, static_argnames="probe")(
        jparts, jnp.asarray(pid), jnp.asarray(qk), probe=jidx.probe)
    got = TQ.bounds_on_rows(ex.parts, _t(pid).long(), _t(qk),
                            probe=ex.index.probe)
    assert got.dtype == torch.int32 and _eq(got, want)


@pytest.mark.parametrize("z_depth", [2, 3])
@pytest.mark.parametrize("cap", [16, 256])
def test_range_window_at_bitwise(win, cap, z_depth):
    x, y, ex, jidx, jparts = win
    rects = np.concatenate([
        jds.random_rects(40, 1e-3, (0, 0, 1, 1), seed=cap, centers=(x, y)),
        jds.random_rects(8, 3e-2, (0, 0, 1, 1), seed=cap + 1)])
    b = np.asarray(jidx.part_bounds)
    pids, valid, boxes = _candidates(rects, b, 8, cap)
    kw = dict(cap=cap, radix_bits=jidx.radix_bits, probe=jidx.probe,
              z_depth=z_depth)
    want = jax.jit(lambda *a: JQ.range_window_at(jparts, *a, jidx.key_spec,
                                                 **kw))(
        jnp.asarray(boxes), jnp.asarray(pids), jnp.asarray(valid),
        jnp.asarray(rects))
    got = TQ.range_window_at(ex.parts, _t(boxes), _t(pids).long(),
                             _t(valid), _t(rects), ex.spec, **kw)
    for g, w in zip(got, want):
        assert _eq(g, w)
    assert int(got[0].sum()) > 0 and not bool(got[2].all())


@pytest.mark.parametrize("materialize", [False, True])
def test_circle_window_at_bitwise(win, materialize):
    x, y, ex, jidx, jparts = win
    rng = np.random.default_rng(7)
    ix = rng.integers(0, len(x), 48)
    cx, cy = x[ix], y[ix]
    r = rng.uniform(0.002, 0.03, 48).astype(np.float32)
    rects = np.stack([cx - r, cy - r, cx + r, cy + r], 1).astype(np.float32)
    circ = np.stack([cx, cy, r], 1).astype(np.float32)
    b = np.asarray(jidx.part_bounds)
    pids, valid, boxes = _candidates(rects, b, 8, 7)
    kw = dict(cap=128, radix_bits=jidx.radix_bits, probe=jidx.probe,
              materialize=materialize)
    want = jax.jit(lambda *a: JQ.circle_window_at(
        jparts, *a, jidx.key_spec, **kw))(
        jnp.asarray(boxes), jnp.asarray(pids), jnp.asarray(valid),
        jnp.asarray(rects), jnp.asarray(circ))
    got = TQ.circle_window_at(ex.parts, _t(boxes), _t(pids).long(),
                              _t(valid), _t(rects), _t(circ), ex.spec, **kw)
    assert (got[1] is None) == (not materialize)
    for g, w in zip(got, want):
        if g is not None:
            assert _eq(g, w)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("c", [1, 5, 64])
def test_top_candidates_bitwise(c):
    rng = np.random.default_rng(c)
    flags = rng.random((50, 24)) < 0.3
    flags[0] = False                             # no candidate
    flags[1] = True                              # every column
    flags[2, [3, 17]] = True                     # two, far apart
    want = JL._top_candidates(jnp.asarray(flags), c)
    got = TL._top_candidates(_t(flags), c)
    for g, w in zip(got, want):
        assert _eq(g, w)


def test_compact_ids_and_keep_window_bitwise():
    rng = np.random.default_rng(9)
    vids = rng.integers(0, 1000, (30, 200)).astype(np.int32)
    vids[rng.random(vids.shape) < 0.8] = -1
    vids[0] = -1                                 # all empty
    vids[1] = 7                                  # every slot, one id
    vids[2, ::2] = 3                             # repeated ids
    for keep in (1, 16, 200, 500):
        assert _eq(TL._compact_ids(_t(vids), keep),
                   JL._compact_ids(jnp.asarray(vids), keep))
    cnt = (vids >= 0).sum(1).astype(np.int32)
    cnt[5] += 1                                  # a dropped id: not ok
    for cap, keep in ((4, None), (64, None), (4, 10)):
        got = TL._keep_window(_t(vids), _t(cnt), cap, keep=keep)
        want = JL._keep_window(jnp.asarray(vids), jnp.asarray(cnt), cap,
                               keep=keep)
        assert _eq(got[0], want[0]) and _eq(got[1], want[1])


def test_chunk_cands_pads_inactive():
    boxes = torch.rand(3, 5, 4)
    pids = torch.arange(15).reshape(3, 5)
    act = torch.ones(3, 5, dtype=torch.bool)
    bx, pd, ac = TL._chunk_cands(2, boxes, pids, act)
    assert bx.shape == (3, 3, 2, 4) and pd.shape == ac.shape == (3, 3, 2)
    assert torch.equal(bx[2, :, 1], torch.as_tensor(
        TL.EMPTY_BOX).expand(3, 4))
    assert not ac[2, :, 1].any() and (pd[2, :, 1] == 0).all()
    assert torch.equal(bx[:2].movedim(0, 1).reshape(3, 4, 4), boxes[:, :4])


# -- programs against their JAX counterparts ------------------------------

@pytest.fixture(scope="module")
def taxi():
    x, y = jds.make("taxi", 20000, seed=5)
    jidx = j_build(x, y, j_fit("kdtree", x, y, 12, seed=0))
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    static = dict(eps=jidx.eps, radix_bits=jidx.radix_bits,
                  probe=jidx.probe, overflow_pid=jidx.overflow_pid,
                  key_spec=jidx.key_spec)
    return x, y, jidx, leaves, static


def _port_executor(taxi, source, **cfg):
    x, y, _, leaves, static = taxi
    if source == "port_build":
        idx = build_index(x, y, fit("kdtree", x, y, 12, seed=0),
                          device="cpu")
    else:
        idx = convert.index_from_arrays(leaves, device="cpu", **static)
    return Executor(idx, EngineConfig(**cfg), device="cpu")


def _jax_run(jidx, prog, *args):
    parts = JL.part_arrays(jidx)
    out = jax.jit(lambda *a: prog(parts, jidx.part_bounds, *a,
                                  axis=None))(*args)
    return out if isinstance(out, tuple) else (out,)


def _circles(x, y, n, seed):
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), n)
    cx, cy = x[ix].copy(), y[ix].copy()
    cx[-4:] = rng.random(4)
    r = rng.uniform(0.002, 0.04, n).astype(np.float32)
    r[0] = 0.0
    return cx, cy, r


def _jax_circle_args(jidx, cx, cy, r):
    rects = jnp.stack([cx - r, cy - r, cx + r, cy + r], axis=-1)
    klo, khi = JK.rect_key_range(rects, jidx.key_spec)
    return (rects, JK.keys_to_f32(klo), JK.keys_to_f32(khi),
            jnp.stack([jnp.asarray(cx), jnp.asarray(cy),
                       jnp.asarray(r)], -1))


def _both(taxi, source, chunk_elems, make_t, make_j, targs, jargs):
    x, y, jidx, _, _ = taxi
    ex = _port_executor(taxi, source, scan_chunk_elems=chunk_elems)
    jpad = JL.pad_partitions(jidx, 8)
    jcfg = JConfig(scan_chunk_elems=chunk_elems)
    got = ex._call(make_t(ex), *targs(ex))
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_run(jpad, make_j(jpad, jcfg), *jargs(jpad))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _eq(g, w)
    return got


SOURCES = ["port_build", "converted"]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("cap,cand", [(16, 4), (64, 8), (1024, 16)])
def test_range_window_program_bitwise(taxi, source, cap, cand):
    x, y = taxi[0], taxi[1]
    rects = np.concatenate([
        jds.random_rects(48, 1e-4, (0, 0, 1, 1), seed=cap, centers=(x, y)),
        jds.random_rects(16, 3e-3, (0, 0, 1, 1), seed=cap + 1)])
    z = np.zeros(len(rects), np.float32)
    got = _both(
        taxi, source, 1 << 26,
        lambda ex: TL._RangeWindowLocal(ex.index, ex.cfg, ex.backend, cap,
                                        cand),
        lambda j, c: JL._RangeWindowLocal(j, c, XlaBackend(), cap, cand),
        lambda ex: (_t(rects), _t(z), _t(z)),
        lambda j: (jnp.asarray(rects), z, z))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("materialize,chunk_elems", [
    (False, 1 << 26), (True, 1 << 26), (True, 1000)],
    ids=["count", "materialize", "materialize_chunked"])
def test_circle_window_program_bitwise(taxi, source, materialize,
                                       chunk_elems):
    x, y, jidx = taxi[0], taxi[1], taxi[2]
    cx, cy, r = _circles(x, y, 40, 11)
    if chunk_elems < 1 << 26:
        # one row's candidate plane passes the budget, so the port runs
        # one-row chunks and both packages take the chunked compaction
        assert chunk_elems // (4 * 64) < 8
    got = _both(
        taxi, source, chunk_elems,
        lambda ex: TL._CircleWindowLocal(ex.index, ex.cfg, ex.backend, 64,
                                         8, materialize),
        lambda j, c: JL._CircleWindowLocal(j, c, XlaBackend(), 64, 8,
                                           materialize),
        lambda ex: ex._circle_args((cx, cy, r)),
        lambda j: _jax_circle_args(j, cx, cy, r))
    assert int(got[0].sum()) > 0 and bool(got[-1].any())


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("chunk", [1, 8])
def test_circle_count_program_bitwise(taxi, source, chunk):
    x, y, jidx = taxi[0], taxi[1], taxi[2]
    cx, cy, r = _circles(x, y, 40, 12)
    ex = _port_executor(taxi, source, part_chunk=chunk)
    got = ex._circle_exact(ex._circle_args((cx, cy, r)))
    jpad = JL.pad_partitions(jidx, chunk)
    want = _jax_run(jpad, JL._CircleCountLocal(jpad, JConfig(
        part_chunk=chunk), XlaBackend()), *_jax_circle_args(jpad, cx, cy,
                                                           r))
    assert _eq(got, want[0]) and int(got.sum()) > 0


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("cap,chunk_elems", [
    (64, 1 << 26), (256, 1 << 26), (256, 4000)],
    ids=["monolithic64", "monolithic256", "chunked256"])
def test_knn_pruned_program_bitwise(taxi, source, cap, chunk_elems):
    x, y = taxi[0], taxi[1]
    rng = np.random.default_rng(cap)
    ix = rng.integers(0, len(x), 48)
    qx = np.concatenate([x[ix], rng.random(16).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(16).astype(np.float32)])
    r0 = rng.uniform(1e-4, 5e-3, 64).astype(np.float32)
    if chunk_elems < 1 << 26:
        # one row's candidate plane passes the budget, so the port runs
        # one-row chunks and both packages take the chunked rounds
        assert chunk_elems // (4 * cap) < 8
    got = _both(
        taxi, source, chunk_elems,
        lambda ex: TL._KnnPrunedLocal(ex.index, ex.cfg, ex.backend, 10,
                                      8, cap),
        lambda j, c: JL._KnnPrunedLocal(j, c, XlaBackend(), 10, j.key_spec,
                                        8, cap),
        lambda ex: (_t(qx), _t(qy), _t(r0)),
        lambda j: (jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(r0)))
    assert bool(got[2].any())


@pytest.mark.parametrize("materialize", [False, True])
def test_row_chunks_equal_one_call(taxi, materialize):
    """A call split into query-row chunks (a scan_chunk_elems below the
    call's windowed planes) gives the unsplit call's outputs. The budget
    qn * 4 * cap * cand keeps the candidate planes whole, so only the
    row split differs."""
    x, y = taxi[0], taxi[1]
    cx, cy, r = _circles(x, y, 40, 13)
    ex = _port_executor(taxi, "port_build")
    args = ex._circle_args((cx, cy, r))
    qn, cand = len(cx), 8
    progs = [lambda e: TL._CircleWindowLocal(e.index, e.cfg, e.backend,
                                             256, cand, materialize),
             lambda e: TL._KnnPrunedLocal(e.index, e.cfg, e.backend, 5,
                                          cand, 64),
             lambda e: TL._RangeWindowLocal(e.index, e.cfg, e.backend, 64,
                                            cand)]
    qargs = [args, (args[3][:, 0].contiguous(), args[3][:, 1].contiguous(),
                    args[3][:, 2] + 1e-3), args[:3]]
    for make, a in zip(progs, qargs):
        whole = ex._call(make(ex), *a)
        cap = make(ex).cap
        budget = qn * 4 * cap * cand
        ex_b = Executor(ex.index, EngineConfig(scan_chunk_elems=budget),
                        device="cpu")
        prog = make(ex_b)
        rows = budget // (min(cand, ex.index.num_partitions) * 4 *
                          (cap + prog.lookup_elems))
        assert 1 <= rows < qn                       # the row split engages
        split = ex_b._call(prog, *a)
        assert all(torch.equal(s, v) for s, v in zip(split, whole))
