"""The bitwise hazards of the circle, polygon-join and pruned-kNN paths,
measured against the JAX package (jax on the CPU, XLA:CPU).

For each float32 expression the port must round as the reference does,
the test builds inputs on which the fused form (one rounding:
``fma(dx, dx, dy*dy)``, ``fma(t, x2 - x1, x1)``) and the unfused form
(a rounding after every operation) disagree, runs the reference's own
code at each site, and checks bitwise that the reference agrees with
the fused form on every input, and that the unfused form would not.
The port's plain versions and kernels use the fused form at these sites
(``_num.fma_f32`` and ``__fmaf_rn``).

Sites: the circle distance in ``kernels/ref.py:circle_count``,
``XlaBackend.circle_scan``, the Pallas ``circle_filter`` (interpret
mode) and ``queries.circle_window_at``; the ray crossing in
``queries.point_in_polygon`` (the Pallas ``point_in_polygon`` cannot run
on this jax); the pruned-kNN distance in ``_KnnPrunedLocal`` (both the
monolithic and the chunked round).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import build_index as j_build, fit as j_fit
from repro.core import local_ops as JL
from repro.core import queries as JQ
from repro.core.backends import XlaBackend
from repro.data import spatial as jds
from repro.kernels import ops, ref
from repro_torch._num import fma_f32
from repro_torch.kernels import point_in_polygon as t_pip

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)


def _f32(a):
    return np.asarray(a, np.float32)


def _fused_d2(dx, dy):
    a, b = torch.from_numpy(_f32(dx)), torch.from_numpy(_f32(dy))
    return fma_f32(a, a, b * b).numpy()


def _unfused_d2(dx, dy):
    dx, dy = _f32(dx), _f32(dy)
    return _f32(_f32(dx * dx) + _f32(dy * dy))


# -- the circle distance -------------------------------------------------

@pytest.fixture(scope="module")
def circle_case():
    """Circles, and points near each rim on which the fused and unfused
    distance tests disagree, among uniform background points."""
    rng = np.random.default_rng(4)
    nc = 16
    cx = _f32(rng.uniform(0.3, 0.7, nc))
    cy = _f32(rng.uniform(0.3, 0.7, nc))
    r = _f32(rng.uniform(0.005, 0.02, nc))
    xs, ys = [rng.random(3000).astype(np.float32)], []
    ys.append(rng.random(3000).astype(np.float32))
    for i in range(nc):
        ang = rng.uniform(0, 2 * np.pi, 20000)
        px = _f32(cx[i] + r[i] * np.cos(ang))
        py = _f32(cy[i] + r[i] * np.sin(ang))
        dx, dy = px - cx[i], py - cy[i]
        rr = _f32(r[i] * r[i])
        flip = (_fused_d2(dx, dy) <= rr) != (_unfused_d2(dx, dy) <= rr)
        xs.append(px[flip][:20])
        ys.append(py[flip][:20])
    x, y = np.concatenate(xs), np.concatenate(ys)

    def counts(d2_of):
        out = []
        for i in range(nc):
            dx, dy = x - cx[i], y - cy[i]
            inr = ((x >= cx[i] - r[i]) & (x <= cx[i] + r[i]) &
                   (y >= cy[i] - r[i]) & (y <= cy[i] + r[i]))
            out.append(int((inr & (d2_of(dx, dy) <= r[i] * r[i])).sum()))
        return np.asarray(out, np.int32)

    fused, unfused = counts(_fused_d2), counts(_unfused_d2)
    assert (fused != unfused).sum() >= nc // 2      # the hazard is real
    return x, y, cx, cy, r, fused


def test_circle_distance_fused_in_ref_backend_and_pallas(circle_case):
    x, y, cx, cy, r, fused = circle_case
    n = len(x)
    rects = jnp.asarray(np.stack([cx - r, cy - r, cx + r, cy + r], 1))
    circ = jnp.asarray(np.stack([cx, cy, r], 1))
    se = jnp.asarray(np.tile([0.0, n], (len(cx), 1)), jnp.float32)
    args = (rects, se, circ, n, jnp.asarray(x), jnp.asarray(y))
    assert np.array_equal(np.asarray(jax.jit(ref.circle_count)(*args)),
                          fused)
    assert np.array_equal(
        np.asarray(ops.circle_count(*args, interpret=True)), fused)
    part = {"keys_f": jnp.zeros(n), "count": jnp.int32(n),
            "x": jnp.asarray(x), "y": jnp.asarray(y)}
    scan = jax.jit(XlaBackend().circle_scan)
    s = jnp.zeros(len(cx), jnp.int32)
    got = scan(part, rects, s, s + n, circ)
    assert np.array_equal(np.asarray(got), fused)


def test_circle_distance_fused_in_window_gather(circle_case):
    """queries.circle_window_at through the JAX windowed program at the
    widest tier (every window whole), and the port's engine."""
    from repro_torch.core import SpatialEngine, build_index, fit

    x, y, cx, cy, r, fused = circle_case
    idx = JL.pad_partitions(j_build(x, y, j_fit("kdtree", x, y, 4,
                                                seed=0)), 8)
    prog = JL._CircleWindowLocal(idx, JConfig(), XlaBackend(), idx.n_pad,
                                 idx.num_partitions, materialize=False)
    rects = jnp.asarray(np.stack([cx - r, cy - r, cx + r, cy + r], 1))
    circ = jnp.asarray(np.stack([cx, cy, r], 1))
    z = jnp.zeros(len(cx))
    cnt, ok = jax.jit(lambda *a: prog(JL.part_arrays(idx), idx.part_bounds,
                                      *a, axis=None))(rects, z, z, circ)
    assert bool(np.all(ok))
    assert np.array_equal(np.asarray(cnt), fused)
    eng = SpatialEngine(build_index(x, y, fit("kdtree", x, y, 4, seed=0),
                                    device="cpu"), device="cpu")
    assert np.array_equal(eng.circle_count(cx, cy, r).numpy(), fused)


# -- the ray crossing ----------------------------------------------------

def _unfused_pip(px, py, poly, ne):
    """queries.point_in_polygon with a rounding after every operation."""
    parity = np.zeros(px.shape, bool)
    for i in range(ne):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % ne]
        den = np.float32(1e-30) if y2 == y1 else _f32(y2 - y1)
        t = _f32(_f32(py - y1) / den)
        xin = _f32(x1 + _f32(t * _f32(x2 - x1)))
        parity ^= ((y1 > py) != (y2 > py)) & (px < xin)
    return parity


def test_ray_crossing_fused():
    """Points placed on the smaller of the two crossings of an edge
    (fused vs unfused): the reference's flags are the fused ones."""
    polys, ne = jds.random_polygons(48, (0, 0, 1, 1), seed=5)
    rng = np.random.default_rng(6)
    jit_pip = jax.jit(ref.point_in_polygon)
    n_flip = 0
    for g in range(len(ne)):
        poly, e = polys[g], int(ne[g])
        x1, y1 = poly[:e, 0], poly[:e, 1]
        x2, y2 = np.roll(poly[:e, 0], -1), np.roll(poly[:e, 1], -1)
        u = rng.random((200, e)).astype(np.float32)
        py = _f32(np.minimum(y1, y2) + u * np.abs(y2 - y1))
        t = _f32(_f32(py - y1) / _f32(y2 - y1))
        dx = np.broadcast_to(_f32(x2 - x1), t.shape)
        fused = fma_f32(torch.from_numpy(t), torch.from_numpy(dx.copy()),
                        torch.from_numpy(np.broadcast_to(
                            x1, t.shape).copy())).numpy()
        unfused = _f32(x1 + _f32(t * dx))
        sel = (fused != unfused) & (y1 != y2)
        px = np.minimum(fused, unfused)[sel]
        py = py[sel]
        want = np.asarray(jit_pip(poly, e, px, py)).astype(bool)
        got = t_pip.point_in_polygon_plain(
            torch.from_numpy(px), torch.from_numpy(py),
            torch.from_numpy(poly), torch.tensor(e)).numpy()
        assert np.array_equal(got, want), g
        n_flip += int((_unfused_pip(px, py, poly, e) != want).sum())
    assert n_flip > 100                             # the hazard is real


# -- the pruned-kNN distance ---------------------------------------------

@pytest.mark.parametrize("chunk_elems", [1 << 26, 4096],
                         ids=["monolithic", "chunked"])
def test_pruned_knn_distance_fused(chunk_elems):
    x, y = jds.make("taxi", 6000, seed=8)
    idx = JL.pad_partitions(j_build(x, y, j_fit("kdtree", x, y, 6,
                                                seed=0)), 8)
    cfg = JConfig(scan_chunk_elems=chunk_elems)
    prog = JL._KnnPrunedLocal(idx, cfg, XlaBackend(), 10, idx.key_spec,
                              cand=8, cap=256)
    ix = np.random.default_rng(9).integers(0, len(x), 64)
    qx, qy = x[ix] + np.float32(1e-3), y[ix]
    r0 = jnp.full(64, 0.005, jnp.float32)
    neg, vid, ok = jax.jit(lambda *a: prog(JL.part_arrays(idx),
                                           idx.part_bounds, *a,
                                           axis=None))(qx, qy, r0)
    neg, vid, ok = map(np.asarray, (neg, vid, ok))
    hit = ok[:, None] & (vid >= 0)
    assert hit.mean() > 0.5
    d2 = -neg[hit]
    dx, dy = x[vid[hit]] - qx.repeat(10)[hit.ravel()], \
        y[vid[hit]] - qy.repeat(10)[hit.ravel()]
    assert np.array_equal(d2, _fused_d2(dx, dy))
    assert (d2 != _unfused_d2(dx, dy)).mean() > 0.05
