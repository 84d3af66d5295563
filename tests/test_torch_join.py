"""Port parity of the polygon join: the data generator, the ray-casting
test (the ``point_in_polygon`` kernel's plain version), the fused join
count, and the windowed and full join programs, against the JAX package
(``xla`` backend, jitted as its engine runs them; the Pallas
``point_in_polygon`` cannot run on this jax, so the plain version is
held against ``kernels/ref.py``).

Every comparison is bitwise: flags, counts and ok flags.
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
from repro.core.backends import XlaBackend
from repro.data import spatial as jds
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core import (EngineConfig, Executor, SpatialEngine,
                              SpatialJoin)
from repro_torch.core import build as TB
from repro_torch.core import build_index, fit
from repro_torch.core import local_ops as TL
from repro_torch.data import spatial as tds
from repro_torch.kernels import point_in_polygon as t_pip

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

ref_pip = jax.jit(ref.point_in_polygon)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bounds", [(0, 0, 1, 1), (0.2, -1.0, 0.6, 3.5)])
@pytest.mark.parametrize("seed", [0, 17])
def test_random_polygons_verbatim(seed, bounds):
    want = jds.random_polygons(20, bounds, seed=seed, max_edges=9)
    got = tds.random_polygons(20, bounds, seed=seed, max_edges=9)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _hard_polygons():
    """Concave and degenerate polygons, padded to E = 10 vertices: a
    concave 'L' with horizontal and vertical edges, a comb, a triangle, a
    polygon whose padding holds garbage, a two-vertex sliver, and a
    single point."""
    polys = np.zeros((6, 10, 2), np.float32)
    ne = np.asarray([6, 8, 3, 4, 2, 1], np.int32)
    polys[0, :6] = [[0.1, 0.1], [0.6, 0.1], [0.6, 0.3], [0.3, 0.3],
                    [0.3, 0.7], [0.1, 0.7]]
    polys[1, :8] = [[0.2, 0.2], [0.8, 0.2], [0.8, 0.8], [0.65, 0.8],
                    [0.65, 0.4], [0.5, 0.4], [0.5, 0.8], [0.2, 0.8]]
    polys[2, :3] = [[0.25, 0.25], [0.75, 0.3], [0.4, 0.9]]
    polys[3, :4] = [[0.3, 0.3], [0.7, 0.3], [0.7, 0.7], [0.3, 0.7]]
    polys[3, 4:] = 5.0                               # padding: never read
    polys[4, :2] = [[0.2, 0.2], [0.8, 0.8]]
    polys[5, :1] = [[0.5, 0.5]]
    return polys, ne


def _probe_points(polys, ne, seed):
    """Random points, every vertex, edge midpoints and points at the
    vertices' heights (on horizontal edges)."""
    rng = np.random.default_rng(seed)
    pts = [rng.random((3000, 2)).astype(np.float32)]
    for poly, e in zip(polys, ne):
        v = poly[:e]
        w = np.roll(v, -1, axis=0)
        pts += [v, (v + w) / 2, np.stack([rng.random(e), v[:, 1]], 1)]
    p = np.concatenate(pts).astype(np.float32)
    return p[:, 0].copy(), p[:, 1].copy()


@pytest.mark.parametrize("which", ["hard", "random"])
def test_point_in_polygon_plain_vs_ref(which):
    if which == "hard":
        polys, ne = _hard_polygons()
    else:
        polys, ne = jds.random_polygons(16, (0, 0, 1, 1), seed=3,
                                        radius=0.2)
    x, y = _probe_points(polys, ne, 1)
    got = t_pip.point_in_polygon_plain(_t(x)[None], _t(y)[None],
                                       _t(polys), _t(ne)).numpy()
    assert got.shape == (len(ne), len(x))
    for g in range(len(ne)):
        want = np.asarray(ref_pip(polys[g], ne[g], x, y))
        assert np.array_equal(got[g].astype(np.int32), want), g
    assert got.any() and not got.all()


@pytest.fixture(scope="module")
def jidx():
    x, y = jds.make("taxi", 6000, seed=3)
    return x, y, JL.pad_partitions(j_build(x, y, j_fit("kdtree", x, y, 6,
                                                        seed=0)), 8)


def test_join_count_plain_vs_xla_join_scan(jidx):
    """join_count_plain (the kernel's plain version, a chunk of
    partitions) against the reference's XlaBackend.join_scan, partition
    by partition, with random learned bounds and active flags."""
    x, y, idx = jidx
    polys, ne = jds.random_polygons(12, (0, 0, 1, 1), seed=4, radius=0.15)
    polys[0], ne[0] = 0.0, 6                  # the concave 'L'
    polys[0, :10] = _hard_polygons()[0][0]
    em = np.arange(polys.shape[1])[None, :, None] < ne[:, None, None]
    mbrs = np.concatenate([np.where(em, polys, 3e38).min(1),
                           np.where(em, polys, -3e38).max(1)],
                          1).astype(np.float32)
    rng = np.random.default_rng(5)
    c, n_pad = idx.num_partitions, idx.n_pad
    s = rng.integers(0, n_pad // 2, (c, 12)).astype(np.int32)
    e = (s + rng.integers(0, n_pad, (c, 12))).astype(np.int32)
    s[:, 0], e[:, 0] = 0, n_pad
    active = rng.random((c, 12)) < 0.8
    got = t_pip.join_count(_t(polys), _t(ne), _t(mbrs), _t(s), _t(e),
                           _t(active), _t(idx.count), _t(idx.x),
                           _t(idx.y)).numpy()
    scan = jax.jit(XlaBackend().join_scan)
    keys_f = JK.keys_to_f32(idx.key)
    for p in range(c):
        part = {"keys_f": keys_f[p], "count": idx.count[p], "x": idx.x[p],
                "y": idx.y[p]}
        want = scan(part, jnp.asarray(polys), jnp.asarray(ne),
                    jnp.asarray(mbrs), jnp.asarray(s[p]), jnp.asarray(e[p]),
                    jnp.asarray(active[p]))
        assert np.array_equal(got[p], np.asarray(want)), p
    assert got.sum() > 0


# -- programs and the facade ----------------------------------------------

@pytest.fixture(scope="module")
def taxi():
    x, y = jds.make("taxi", 20000, seed=6)
    jidx = j_build(x, y, j_fit("kdtree", x, y, 12, seed=0))
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    static = dict(eps=jidx.eps, radix_bits=jidx.radix_bits,
                  probe=jidx.probe, overflow_pid=jidx.overflow_pid,
                  key_spec=jidx.key_spec)
    polys, ne = jds.random_polygons(24, (0.05, 0.05, 0.95, 0.95), seed=7,
                                    radius=0.06)
    return x, y, jidx, leaves, static, polys, ne


def _port_index(taxi, source):
    x, y, _, leaves, static, _, _ = taxi
    if source == "port_build":
        return build_index(x, y, fit("kdtree", x, y, 12, seed=0),
                           device="cpu")
    return convert.index_from_arrays(leaves, device="cpu", **static)


def _mbr_k_jax(jidx, polys, ne):
    polys, ne = jnp.asarray(polys), jnp.asarray(ne)
    em = JL._edge_mask(polys, ne)
    mbrs = jnp.concatenate([jnp.min(jnp.where(em, polys, 3e38), axis=1),
                            jnp.max(jnp.where(em, polys, -3e38), axis=1)],
                           axis=-1)
    klo, khi = JK.rect_key_range(mbrs, jidx.key_spec)
    return (polys, ne, jnp.concatenate(
        [mbrs, JK.keys_to_f32(klo)[:, None], JK.keys_to_f32(khi)[:, None]],
        axis=-1))


def _jax_run(jidx, prog, *args):
    parts = JL.part_arrays(jidx)
    out = jax.jit(lambda *a: prog(parts, jidx.part_bounds, *a,
                                  axis=None))(*args)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("source", ["port_build", "converted"])
@pytest.mark.parametrize("cap,cand", [(32, 4), (128, 8), (2048, 16)])
def test_join_window_program_bitwise(taxi, source, cap, cand):
    _, _, jidx, _, _, polys, ne = taxi
    ex = Executor(_port_index(taxi, source), device="cpu")
    jpad = JL.pad_partitions(jidx, 8)
    got = ex._call(TL._JoinLocal(ex.index, ex.cfg, ex.backend, cap, cand),
                   *ex._join_args((polys, ne)))
    want = _jax_run(jpad, JL._JoinLocal(jpad, JConfig(), XlaBackend(), cap,
                                        cand), *_mbr_k_jax(jpad, polys, ne))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("source", ["port_build", "converted"])
@pytest.mark.parametrize("chunk", [1, 8])
def test_join_full_program_bitwise(taxi, source, chunk):
    _, _, jidx, _, _, polys, ne = taxi
    ex = Executor(_port_index(taxi, source), EngineConfig(part_chunk=chunk),
                  device="cpu")
    got = ex.run(SpatialJoin(mode="full"), polys, ne)
    jpad = JL.pad_partitions(jidx, chunk)
    want = _jax_run(jpad, JL._JoinFullLocal(jpad, JConfig(part_chunk=chunk),
                                            XlaBackend()),
                    *_mbr_k_jax(jpad, polys, ne))[0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def test_join_count_windowed_equals_full_and_jax(taxi):
    from repro.core import SpatialEngine as JEngine

    x, y, jidx, _, _, polys, ne = taxi
    eng = SpatialEngine(_port_index(taxi, "port_build"), device="cpu")
    win = eng.join_count(polys, ne)
    full = eng.join_count(polys, ne, mode="full")
    assert torch.equal(win, full)
    jeng = JEngine(jidx)
    assert np.array_equal(win.numpy(), np.asarray(jeng.join_count(polys,
                                                                  ne)))
    inside = np.zeros(len(ne), np.int64)      # brute force, ray casting
    for g in range(len(ne)):
        inside[g] = int(np.asarray(ref_pip(polys[g], ne[g], x, y)).sum())
    assert np.array_equal(win.numpy(), inside)
