"""Float32 denormals, read as XLA:CPU reads them, on every query path.

XLA:CPU (the reference's backend here) reads every float32 denormal
input of an arithmetic op or a compare as zero (``1e-45 == 0.0``), and
writes zero for every result whose value, rounded to 24 bits with an
unbounded exponent, is below 2^-126. Eager torch and CUDA keep
denormals, so the port flushes at each site (``repro_torch._num``; the
kernels' ``daz``/``ftz`` in ``kernels/csrc/common.cuh``).

Checked bitwise on the CPU:

  * ``_num``'s float32 ops against jitted jax on values at the rule's
    edges (the midpoint below 2^-126 that the denormal grid rounds up);
  * the key step: a denormal coordinate, a denormal ``v - lo`` or a
    denormal bound never moves a quantized key (no flush there);
  * each kernel's plain version against ``kernels/ref.py`` (jitted);
  * every query family (range count and query, circle count and query,
    exact and pruned kNN, windowed and full join) through the JAX
    ``Executor`` (xla backend) and the port's, on data with points at
    0.0, +-1e-45 and +-1e-39 and pairs of normal coordinates near 2^-126
    whose difference is denormal, with a query of each family on those
    values; each case asserted to need the flush (the unflushed answer
    differs);
  * the case found in the point query's slice: gaussian points on R-tree
    leaves, 120 of them at x = 0.0, one rect with x from 1e-45 to 0.02:
    13 points with the flush, 7 without.

The CUDA kernels are held against these plain versions on the same
inputs by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import keys as JK
from repro.kernels import ref
from repro_torch import _num as N
from repro_torch import convert
from repro_torch import core as T
from repro_torch.core import build as TB
from repro_torch.core import keys as TK
from repro_torch.kernels import circle_filter as t_cf
from repro_torch.kernels import knn_topk as t_knn
from repro_torch.kernels import point_in_polygon as t_pip
from repro_torch.kernels import range_filter as t_rf
from test_torch_gpu import (denormal_points, denormal_queries,
                            point_points)

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

F32 = np.float32
TINY = F32(2.0 ** -126)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(want, got, what=""):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape, what
    assert want.tobytes() == got.tobytes(), what


# -- the float32 ops -------------------------------------------------------

def _edge_values():
    """Values at the rule's edges: denormals, 2^-126 and its neighbours,
    the square roots of both sides of 2^-126, and random ones near them."""
    h = F32(2.0 ** -63)
    v = [0.0, 1e-45, 1e-39, TINY, np.nextafter(TINY, F32(1)),
         np.nextafter(TINY, F32(0)), 1.25 * TINY, 1.5 * TINY, 2 * TINY,
         h, np.nextafter(h, F32(0)), np.nextafter(h, F32(1)),
         F32(1 - 2.0 ** -24), F32(1 - 2.0 ** -23), F32(1 + 2.0 ** -23),
         1.0, 0.5, 3.0, 1e-30, 3e38]
    rng = np.random.default_rng(0)
    v += list(TINY * rng.uniform(0.5, 4.0, 12))
    v += list(h * rng.uniform(0.9, 1.1, 12))
    v = np.asarray(v, F32)
    return np.concatenate([v, -v])


def test_float32_ops_flush_as_xla():
    """sub/add/mul/div/fma/dist2 on every pair (and triple) of edge
    values, bitwise jitted jax; the inputs flushed first, as XLA:CPU
    reads them. The unflushed float32 results differ on some pairs."""
    v = _edge_values()
    a, b = (m.ravel() for m in np.meshgrid(v, v))
    c = np.resize(v[::-1], a.shape)
    fa, fb, fc = (N.flush_denormals(_t(u)) for u in (a, b, c))
    cases = [("sub", N.sub_f32(fa, fb), lambda p, q, r: p - q),
             ("add", N.add_f32(fa, fb), lambda p, q, r: p + q),
             ("mul", N.mul_f32(fa, fb), lambda p, q, r: p * q),
             ("div", N.div_f32(fa, fb), lambda p, q, r: p / q),
             ("fma", N.fma_f32(fa, fb, fc), lambda p, q, r: p * q + r),
             ("dist2", N.dist2_f32(fa, fb), lambda p, q, r: p * p + q * q)]
    for what, got, fn in cases:
        want = np.asarray(jax.jit(fn)(a, b, c))
        assert want.tobytes() == got.numpy().tobytes(), what
    # the midpoint 2^-126 - 2^-150: XLA:CPU gives 0, the denormal grid
    # rounds it up to 2^-126
    m = F32(1 - 2.0 ** -24)
    assert float(np.multiply(m, TINY)) == float(TINY)
    assert float(jax.jit(lambda p, q: p * q)(m, TINY)) == 0.0
    assert float(N.mul_f32(_t([m]), _t([TINY]))[0]) == 0.0
    raw = (_t(a) * _t(b)).numpy()
    assert raw.tobytes() != np.asarray(
        jax.jit(lambda p, q: p * q)(a, b)).tobytes()


def test_distance_needs_no_input_flush():
    """``dist2_f32`` of differences of UNflushed coordinates equals
    XLA:CPU's fused ``(px - qx)**2 + (py - qy)**2`` (which reads the
    coordinates flushed) bitwise: a difference that is only squared needs
    no flush. Coordinates: the edge values, their sums with 2^-126-sized
    offsets, and values near 2^-63 apart."""
    v = _edge_values()
    v = np.concatenate([v, v + TINY, v - F32(1e-39),
                        F32(0.25) + v * F32(2.0 ** 40)]).astype(F32)
    rng = np.random.default_rng(1)
    px, qx, py, qy = (rng.choice(v, 20000) for _ in range(4))
    want = np.asarray(jax.jit(
        lambda a, b, c, d: (a - b) ** 2 + (c - d) ** 2)(px, qx, py, qy))
    got = N.dist2_f32(_t(px) - _t(qx), _t(py) - _t(qy))
    assert want.tobytes() == got.numpy().tobytes()


# -- the key step (measured: no flush needed) ------------------------------

KEY_SPECS = [("morton", 11, (0.0, 0.0, 1.0, 1.0)),
             ("morton", 12, (-1e-39, -1e-39, 1.0, 1.0)),
             ("morton", 11, (-1.25 * float(TINY), 0.0, 0.75, 1.0)),
             ("x", 12, (1e-45, 0.0, 1.0, 1.0)),
             ("y", 11, (0.0, -1e-45, 1.0, 2.0)),
             ("morton", 12, (0.0, 0.0, 2.0 ** -80, 2.0 ** -80))]


@pytest.mark.parametrize("kind,bits,bounds", KEY_SPECS)
def test_key_step_needs_no_flush(kind, bits, bounds):
    """``keys.make_keys`` / ``rect_key_range`` on denormal coordinates,
    coordinates whose ``v - lo`` is denormal, and denormal bounds: the
    port's keys (unflushed) equal the reference's, and equal the keys of
    the flushed coordinates, so the key step has nothing to flush."""
    v = _edge_values()
    v = np.concatenate([v[np.abs(v) < 1e-20], np.asarray(bounds, F32),
                        np.nextafter(np.asarray(bounds, F32), F32(1)),
                        np.linspace(0, 1, 33, dtype=F32)])
    x, y = (m.ravel() for m in np.meshgrid(v, v))
    tspec = TK.KeySpec(kind=kind, bits_per_dim=bits, bounds=bounds)
    jspec = JK.KeySpec(kind=kind, bits_per_dim=bits, bounds=bounds)
    want = np.asarray(JK.make_keys(jnp.asarray(x), jnp.asarray(y), jspec))
    got = TK.make_keys(_t(x), _t(y), tspec)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    flushed = TK.make_keys(N.flush_denormals(_t(x)),
                           N.flush_denormals(_t(y)), tspec)
    assert torch.equal(got, flushed)
    rects = np.stack([x, y, np.resize(x[::-1], x.shape),
                      np.resize(y[::-1], y.shape)], -1)
    jlo, jhi = JK.rect_key_range(jnp.asarray(rects), jspec)
    tlo, thi = TK.rect_key_range(_t(rects), tspec)
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))


# -- the index and the queries ---------------------------------------------

@pytest.fixture(scope="module", params=["kdtree", "rtree"])
def case(request):
    """The JAX index of the denormal points (kdtree or R-tree leaves),
    carried to the port, the port's own build of the same points, and the
    two executors."""
    x, y = denormal_points()
    if request.param == "kdtree":
        part = J.fit("kdtree", x, y, 6, seed=0)
    else:
        part = J.fit("rtree", x, y, 9, sample_rate=0.05, seed=1)
    jidx = J.build_index(x, y, part)
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    tidx = convert.index_from_arrays(
        leaves, device="cpu", eps=jidx.eps, radix_bits=jidx.radix_bits,
        probe=jidx.probe, overflow_pid=jidx.overflow_pid,
        key_spec=jidx.key_spec)
    tpart = T.fit(request.param, x, y, 6 if request.param == "kdtree" else 9,
                  **({"seed": 0} if request.param == "kdtree"
                     else {"sample_rate": 0.05, "seed": 1}))
    own = T.build_index(x, y, tpart, device="cpu")
    return x, y, jidx, tidx, own


def test_port_build_bitwise_on_denormal_points(case):
    """The port's own build (its partition assignment compares flushed)
    gives the JAX build's leaves, keys and partitions bit for bit."""
    _, _, jidx, _, own = case
    for name in TB.LEAVES:
        want = np.asarray(getattr(jidx, name))
        if want.dtype == np.uint32:         # keys: the port holds int64
            want = want.astype(np.int64)
        _same(want, getattr(own, name), name)


def _families(x, y):
    """(name, JAX spec, port spec, args, raw oracle or None) of every
    family, on the denormal queries."""
    q = denormal_queries()
    out = []
    for name, kw, args in [
            ("RangeCount", {}, (q["rects"],)),
            ("RangeQuery", {}, (q["rects"],)),
            ("CircleQuery", {}, (q["cx"], q["cy"], q["r"])),
            ("CircleQuery", {"materialize": True},
             (q["cx"], q["cy"], q["r"])),
            ("Knn", {"k": 5, "mode": "exact"}, (q["qx"], q["qy"])),
            ("Knn", {"k": 5}, (q["qx"], q["qy"])),
            ("SpatialJoin", {"mode": "full"}, (q["polys"], q["ne"])),
            ("SpatialJoin", {}, (q["polys"], q["ne"]))]:
        out.append((name, getattr(J, name)(**kw), getattr(T, name)(**kw),
                    args))
    return out


def test_every_family_matches_jax_on_denormals(case):
    """Each family through both executors, strict and then serving, every
    output bitwise, with the same host_syncs, dispatches and tiers."""
    x, y, jidx, tidx, _ = case
    jex, tex = J.Executor(jidx), T.Executor(tidx, device="cpu")
    assert jex.backend.name == "xla"
    for strict in (True, False):
        for name, js, ts, args in _families(x, y):
            want, got = jex.run(js, *args, strict=strict), tex.run(
                ts, *args, strict=strict)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for w, g in zip(want, got, strict=True):
                _same(w, g, (name, strict))
            assert jex.host_syncs == tex.host_syncs
            assert jex.dispatches == tex.dispatches
            assert jex._sticky == tex._sticky


def _raw_counts(x, y, q):
    """Brute-force counts with denormals kept (eager numpy float32): the
    port's answers before the flush."""
    rc = np.array([np.sum((x >= r[0]) & (x <= r[2]) & (y >= r[1]) &
                          (y <= r[3])) for r in q["rects"]])
    cc = []
    for cx, cy, r in zip(q["cx"], q["cy"], q["r"]):
        dx, dy = x - cx, y - cy
        cc.append(np.sum(((dx * dx + dy * dy) <= r * r) &
                         (x >= cx - r) & (x <= cx + r) &
                         (y >= cy - r) & (y <= cy + r)))
    return rc, np.asarray(cc)


def _raw_join(x, y, polys, ne):
    """Brute-force join counts with denormals kept (eager numpy float32
    ray casting, the reference's formula unfused)."""
    out = []
    for poly, n in zip(polys, ne):
        p = poly[:n]
        inside = ((x >= p[:, 0].min()) & (x <= p[:, 0].max()) &
                  (y >= p[:, 1].min()) & (y <= p[:, 1].max()))
        par = np.zeros(len(x), bool)
        for i in range(n):
            (x1, y1), (x2, y2) = p[i], p[(i + 1) % n]
            den = np.float32(1e-30) if y2 == y1 else y2 - y1
            with np.errstate(over="ignore", invalid="ignore"):
                xin = x1 + (y - y1) / den * (x2 - x1)
            par ^= ((y1 > y) != (y2 > y)) & (x < xin)
        out.append(np.sum(inside & par))
    return np.asarray(out)


def test_denormal_queries_need_the_flush(case):
    """Each family's denormal queries change the answer: the reference's
    range and circle counts differ from the unflushed brute force, its
    join counts from the unflushed ray casting, and some kNN distance is
    0 where the unflushed one is not."""
    x, y, jidx, _, _ = case
    q = denormal_queries()
    jex = J.Executor(jidx)
    rc, cc = _raw_counts(x, y, q)
    assert (np.asarray(jex.run(J.RangeCount(), q["rects"])) != rc).any()
    assert (np.asarray(jex.run(J.CircleQuery(), q["cx"], q["cy"], q["r"]))
            != cc).any()
    jc = np.asarray(jex.run(J.SpatialJoin(mode="full"), q["polys"],
                            q["ne"]))
    assert (jc != _raw_join(x, y, q["polys"], q["ne"])).any()
    d2, _ = jex.run(J.Knn(k=5, mode="exact"), q["qx"], q["qy"])
    raw = (x[None, :] - q["qx"][:, None]) ** 2 + (
        y[None, :] - q["qy"][:, None]) ** 2
    assert ((np.asarray(d2)[:, 0] == 0) & (raw.min(1) > 0)).any()


def test_point_slice_case_counts_13():
    """Gaussian 3,000 points on R-tree leaves (120 at x = 0.0), a rect
    with x from 1e-45 to 0.02: the reference counts 13 (it reads 1e-45
    as 0.0), the unflushed compare 7, the port 13."""
    x, y, part = point_points("rtree_overflow", J.fit)
    jidx = J.build_index(x, y, part)
    rect = np.asarray([[1e-45, 0.31469545, 0.02, 0.3455271]], F32)
    want = int(np.asarray(J.Executor(jidx).run(J.RangeCount(), rect))[0])
    tidx = T.build_index(x, y, T.fit("rtree", x, y, 9, sample_rate=0.02,
                                     seed=1), device="cpu")
    got = int(T.Executor(tidx, device="cpu").run(T.RangeCount(), rect)[0])
    raw = int(np.sum((x >= rect[0, 0]) & (x <= rect[0, 2]) &
                     (y >= rect[0, 1]) & (y <= rect[0, 3])))
    assert (want, got, raw) == (13, 13, 7)


# -- each kernel's plain version against kernels/ref.py --------------------

@pytest.fixture(scope="module")
def rows(case):
    """Every partition row of the JAX index, whole ([0, count))."""
    _, _, jidx, _, _ = case
    return (np.asarray(jidx.x), np.asarray(jidx.y),
            np.asarray(jidx.count))


def test_range_and_circle_plain_vs_ref(rows):
    x, y, cnt = rows
    q = denormal_queries()
    c, nq = x.shape[0], len(q["cx"])
    circ = np.stack([q["cx"], q["cy"], q["r"]], -1)
    mbr = np.stack([q["cx"] - q["r"], q["cy"] - q["r"], q["cx"] + q["r"],
                    q["cy"] + q["r"]], -1).astype(F32)
    s = np.zeros((c, nq), np.int32)
    e = np.broadcast_to(cnt[:, None], (c, nq)).astype(np.int32)
    act = np.ones((c, nq), bool)
    rect_want = np.stack([np.asarray(jax.jit(ref.range_count)(
        q["rects"][:nq], np.stack([s[p], e[p]], -1), cnt[p], x[p], y[p]))
        for p in range(c)])
    got = t_rf.range_count_plain(_t(q["rects"][:nq]), _t(s), _t(e),
                                 _t(act), _t(cnt), _t(x), _t(y))
    _same(rect_want, got, "range")
    circ_want = np.stack([np.asarray(jax.jit(ref.circle_count)(
        mbr, np.stack([s[p], e[p]], -1), circ, cnt[p], x[p], y[p]))
        for p in range(c)])
    got = t_cf.circle_count_plain(_t(mbr), _t(s), _t(e), _t(circ), _t(act),
                                  _t(cnt), _t(x), _t(y))
    _same(circ_want, got, "circle")


def test_knn_plain_vs_ref(rows):
    x, y, cnt = rows
    q = denormal_queries()
    qxy = np.stack([q["qx"], q["qy"]], -1)
    fn = jax.jit(ref.knn_topk, static_argnames=("k",))
    neg, idx = t_knn.knn_topk_plain(_t(q["qx"]), _t(q["qy"]), _t(cnt),
                                    _t(x), _t(y), k=6)
    for p in range(x.shape[0]):
        wn, wi = fn(qxy, cnt[p], x[p], y[p], k=6)
        _same(wn, neg[p], "d2")
        _same(wi, idx[p], "idx")


def test_point_in_polygon_plain_vs_ref(rows):
    x, y, _ = rows
    q = denormal_queries()
    fn = jax.jit(ref.point_in_polygon)
    got = t_pip.point_in_polygon_plain(_t(x)[:, None, :], _t(y)[:, None, :],
                                       _t(q["polys"])[None],
                                       _t(q["ne"])[None])
    for g in range(len(q["ne"])):
        for p in range(x.shape[0]):
            want = np.asarray(fn(q["polys"][g], q["ne"][g], x[p], y[p]))
            assert np.array_equal(want.astype(bool), got[p, g].numpy())
