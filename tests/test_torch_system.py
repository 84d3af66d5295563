"""End-to-end behaviour of the port: the twins of tests/test_system.py.

The paper's full pipeline on one device (the CPU here): generate
city-scale-ish data -> partition -> build the learned index -> serve a
mixed query workload -> verify every result against the oracles of
tests/conftest.py, and check the paper's qualitative claims: build
scaling, learned interval << partition size (widths bitwise the
reference's), and an index that survives a checkpoint and a restart
(``repro_torch.checkpoint`` with ``convert.index_to_arrays`` and
``index_from_arrays``), frozen and mutated, serving bitwise what the
original serves.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from conftest import knn_oracle, pip_oracle, range_oracle
from repro.checkpoint import save_checkpoint as j_save
from repro.core import SpatialEngine as JEngine
from repro.core import build_index as j_build
from repro.core import queries as JQ
from repro.core import keys as JK
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    read_meta, save_checkpoint)
from repro_torch.core import (CircleQuery, DeleteBatch, Executor,
                              InsertBatch, Knn, PointQuery, RangeCount,
                              RangeQuery, SpatialEngine, SpatialJoin,
                              build_index, fit)
from repro_torch.core import build as TB
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core.backends import TorchBackend
from repro_torch.data import spatial as ds

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def system():
    x, y = ds.make("taxi", 50000, seed=13)
    part = fit("kdtree", x, y, 32, seed=1)
    idx = build_index(x, y, part, device=CPU)
    return x, y, part, idx, SpatialEngine(idx, device=CPU)


_JAX_INDEX = {}


def jax_index(system):
    """The reference's build of the system's points (built once)."""
    if "idx" not in _JAX_INDEX:
        x, y, part = system[:3]
        _JAX_INDEX["idx"] = j_build(x, y, part)
    return _JAX_INDEX["idx"]


def test_mixed_workload_end_to_end(system):
    x, y, part, idx, eng = system
    rng = np.random.default_rng(5)
    # point
    ix = rng.integers(0, len(x), 32)
    found = eng.point_query(x[ix], y[ix]).numpy()
    assert found.all()
    # range
    rects = ds.random_rects(16, 1e-4, part.bounds, seed=17,
                            centers=(x, y))
    assert (eng.range_count(rects).numpy() ==
            range_oracle(x, y, rects)).all()
    # kNN (paper default k=10)
    d2, _ = eng.knn(x[ix[:8]], y[ix[:8]], 10)
    want = knn_oracle(x, y, x[ix[:8]], y[ix[:8]], 10)
    assert np.allclose(np.sort(d2.numpy(), 1), want, rtol=1e-5)
    # join
    polys, ne = ds.random_polygons(6, part.bounds, seed=19)
    got = eng.join_count(polys, ne).numpy()
    want_j = np.array([pip_oracle(x, y, polys[i], ne[i]).sum()
                       for i in range(6)])
    assert (got == want_j).all()


def test_learned_interval_much_smaller_than_partition(system):
    """The spline bounds restrict the scan to a tiny interval — the
    mechanism behind the paper's 2-3 orders-of-magnitude query claim.
    The port's widths (``Backend.bounds``, every partition at once) are
    bitwise the reference's (``queries.learned_bounds`` per partition)
    on the reference's own build of the same points."""
    x, y, part, idx, eng = system
    rects = ds.random_rects(32, 1e-5, part.bounds, seed=23,
                            centers=(x, y))
    klo, khi = K.rect_key_range(torch.as_tensor(rects), idx.key_spec)
    s, e = TorchBackend().bounds(L.part_arrays(idx), K.keys_to_f32(klo),
                                 K.keys_to_f32(khi),
                                 radix_bits=idx.radix_bits,
                                 probe=idx.probe)
    widths = (e - s).numpy()                                # (P, Q)
    w = np.mean(widths)
    assert w < 0.02 * idx.n_pad, (w, idx.n_pad)

    jidx = jax_index(system)
    jlo, jhi = JK.rect_key_range(rects, jidx.key_spec)
    jlo, jhi = JK.keys_to_f32(jlo), JK.keys_to_f32(jhi)
    js, je = jax.vmap(lambda part_p: JQ.learned_bounds(
        part_p, jlo, jhi, radix_bits=jidx.radix_bits,
        probe=jidx.probe))(JEngine(jidx).parts)
    want = np.asarray(je - js)[:jidx.num_partitions]   # not the padding
    assert want.dtype == widths.dtype and want.shape == widths.shape
    assert want.tobytes() == widths.tobytes()


def test_build_scales_subquadratically(system):
    """Index build is one sort + one linear pass; doubling N must not
    quadruple the WORK (sanity check on the O(N log N + N) claim).

    Measured as best-of CPU time (``time.process_time`` sums actual
    compute across threads) rather than wall clock, as the reference's
    test measures it."""
    x, y = ds.make("uniform", 20000, seed=3)
    part = fit("kdtree", x, y, 8, seed=1)

    def best_of(n, f):
        ts = []
        for _ in range(n):
            t0 = time.process_time()
            f()
            ts.append(time.process_time() - t0)
        return min(ts)

    build_index(x, y, part, device=CPU)  # warm caches
    t1 = best_of(5, lambda: build_index(x, y, part, device=CPU).key)
    x2, y2 = ds.make("uniform", 40000, seed=3)
    part2 = fit("kdtree", x2, y2, 8, seed=1)
    build_index(x2, y2, part2, device=CPU)
    t2 = best_of(5, lambda: build_index(x2, y2, part2, device=CPU).key)
    # 2x the rows: O(N log N) predicts ~2.1x work; quadratic would be
    # 4x. 3.2x splits those while tolerating constant-overhead noise.
    assert t2 < 3.2 * max(t1, 1e-3), (t1, t2)


def _sweep(x, y, part):
    """(spec, args) of every query family, strict."""
    rng = np.random.default_rng(29)
    ix = rng.integers(0, len(x), 12)
    qx = np.concatenate([x[ix[:8]], rng.random(4).astype(np.float32)])
    qy = np.concatenate([y[ix[:8]], rng.random(4).astype(np.float32)])
    rects = ds.random_rects(12, 1e-3, part.bounds, seed=31,
                            centers=(x, y))
    r = np.full(12, 0.02, np.float32)
    polys, ne = ds.random_polygons(4, part.bounds, seed=37)
    return [(PointQuery(), qx, qy), (RangeCount(), rects),
            (RangeQuery(), rects), (CircleQuery(), qx, qy, r),
            (CircleQuery(materialize=True), qx, qy, r),
            (Knn(k=7), qx, qy), (Knn(k=7, mode="exact"), qx, qy),
            (SpatialJoin(), polys, ne), (SpatialJoin(mode="full"), polys,
                                         ne)]


def _restore(ckpt, index):
    """Save ``index`` at step 1 of ``ckpt`` and restore it on the CPU
    from a prototype of meta tensors."""
    arrays, statics = convert.index_to_arrays(index)
    save_checkpoint(ckpt, 1, arrays, meta=statics)
    assert latest_step(ckpt) == 1
    meta = read_meta(ckpt, 1)
    proto = convert.leaves_like(meta)
    assert all(t.device.type == "meta" for t in proto.values())
    got = load_checkpoint(ckpt, 1, proto, device=CPU)
    return convert.index_from_arrays(got, device=CPU, **meta)


def _same_service(a, b, x, y, part):
    """Fresh executors on ``a`` and ``b`` answer every family bitwise."""
    ea, eb = Executor(a, device=CPU), Executor(b, device=CPU)
    for spec, *args in _sweep(x, y, part):
        ra = ea.run(spec, *args, strict=True)
        rb = eb.run(spec, *args, strict=True)
        ra = ra if isinstance(ra, tuple) else (ra,)
        rb = rb if isinstance(rb, tuple) else (rb,)
        for u, v in zip(ra, rb):
            assert u.dtype == v.dtype and u.shape == v.shape, spec
            assert u.numpy().tobytes() == v.numpy().tobytes(), spec


def _same_leaves(a, b):
    for name in TB.LEAVES:
        u, v = getattr(a, name), getattr(b, name)
        assert (u is None) == (v is None), name
        if u is not None:
            assert u.dtype == v.dtype and u.is_contiguous(), name
            assert u.numpy().tobytes() == v.numpy().tobytes(), name
    for name in ("eps", "radix_bits", "probe", "overflow_pid", "epoch",
                 "shape_epoch", "key_spec"):
        assert getattr(a, name) == getattr(b, name), name


def test_index_serializes_through_checkpoint(system, tmp_path):
    """The learned index persists through the checkpoint layer (serving
    restart path): restored through ``index_from_arrays`` it is the
    same index, leaf for leaf, and serves every family bitwise; the
    reference's checkpoint of its own build holds the same keys."""
    x, y, part, idx, eng = system
    back = _restore(str(tmp_path / "port"), idx)
    _same_leaves(back, idx)
    _same_service(idx, back, x, y, part)

    jidx = jax_index(system)
    arrays = {f.name: getattr(jidx, f.name)
              for f in dataclasses.fields(jidx)
              if not f.metadata.get("static")
              and getattr(jidx, f.name) is not None}
    j_save(str(tmp_path / "ref"), 1, arrays)
    got = load_checkpoint(str(tmp_path / "ref"), 1,
                          {"key": torch.empty_like(idx.key,
                                                   device="meta")},
                          device=CPU)
    assert torch.equal(got["key"], idx.key)


def test_mutated_index_serializes_through_checkpoint(system, tmp_path):
    """A mutated index (delta leaves grown from none, tombstones, both
    epochs bumped) restores leaf for leaf and serves bitwise."""
    x, y, part, idx, eng = system
    ex = Executor(idx, device=CPU)
    rng = np.random.default_rng(41)
    bx = rng.random(300).astype(np.float32)
    by = rng.random(300).astype(np.float32)
    ex.run(InsertBatch(), bx, by)
    removed = ex.run(DeleteBatch(), np.concatenate([x[:150], bx[:40]]),
                     np.concatenate([y[:150], by[:40]]))
    assert removed >= 190
    mut = ex.index
    assert mut.epoch == 2 and mut.shape_epoch >= 1 and mut.delta_cap > 0
    assert int(mut.dead.sum()) > 0
    back = _restore(str(tmp_path), mut)
    _same_leaves(back, mut)
    _same_service(mut, back, x, y, part)
