"""The port's mutable index on the CPU, bitwise against the JAX package.

The same insert / delete / re-fit sequence goes through the JAX
``Executor`` (xla backend) and the port's (``device="cpu"``); every
count, kNN distance and kNN id order, pre-refit and post-refit, must be
bitwise the JAX executor's AND bitwise a fresh port build of the
surviving points (``build_index(vid=..., n_pad=...)``); materialized ids
are compared as sets against the fresh build (DESIGN.md §10) and bitwise
against the JAX executor.

Ported from tests/test_updates.py at its sizes (N = 6000, 400 inserts,
200 deletes plus 50 of the still-buffered inserts): the pre-refit and
post-refit parity, the targeted re-fit (``verify_eps`` per touched
partition, untouched rows bitwise), the epoch counters, out-of-domain
inserts, the serving session's mutations and ``maintain()`` re-fit, and
the ``shape_epoch`` half of the capacity-growth case. Added: each
``mutate`` step against the reference's on converted inputs; deletes of
float32 denormal coordinates (read as zero, as XLA:CPU reads them); kNN
with fewer live points than k; re-fits that grow the knot width and the
probe, and ``n_pad``. The program cache (DESIGN.md §14):
``test_update_executables_cache_like_queries`` and the ``cache_keys``
half of the capacity-growth case, each against the JAX Executor's keys.

``test_sharded_updates_match_unsharded``'s twin runs on a (2, 2)
("data", "query") mesh of four gloo ranks (tests/_dist_worker.py): two
insert batches (the second grows the delta capacity, 600 copies of one
point in one shard's partition), deletes, the reference test's strict
families (point, range count, range query, kNN), a re-fit that grows
n_pad and the probe on that shard alone, the families again;
every rank agrees on every epoch and static, which equal the reference's
at the same mesh and the unsharded reference's, and every output is the
reference's at the mesh (the unmeshed port's where the reference raises).

Not ported: ``test_postrefit_parity_pallas_backend`` (the Pallas kernels
cannot run on this jax, ROADMAP §3; the port's cuda backend is held
against its torch backend on mutated indexes in tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import mutate as JM
from repro.data import spatial as jds
from repro.serve import SpatialServeSession as JSession
from repro_torch import convert
from repro_torch import core as T
from repro_torch.core import build as TB
from repro_torch.core import local_ops as TL
from repro_torch.core import mutate as TM
from repro_torch.data import spatial as ds
from repro_torch.serve import SpatialServeSession as TSession

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

N = 6000
N_INS = 400
N_DEL = 200
CPU = dict(device="cpu")


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


def assert_same(want, got, what=""):
    """Bitwise equality of two results (JAX arrays, numpy or tensors)."""
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got), what
    for a, b in zip(want, got):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), (what, a, b)


def assert_leaves(jidx, tidx, names=TB.LEAVES):
    """Every named index leaf bitwise (keys as int64), and the statics."""
    for name in names:
        a, b = getattr(jidx, name), getattr(tidx, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        assert_same(a, b, name)
    for attr in ("eps", "probe", "epoch", "shape_epoch", "overflow_pid",
                 "n_pad", "delta_cap", "num_partitions"):
        assert getattr(jidx, attr) == getattr(tidx, attr), attr


def to_port(jidx):
    """The JAX index as a port index, mutable state and epochs included."""
    leaves = {n: getattr(jidx, n) for n in TB.LEAVES}
    leaves = {n: None if v is None else np.asarray(v)
              for n, v in leaves.items()}
    return convert.index_from_arrays(
        leaves, device="cpu", eps=jidx.eps, radix_bits=jidx.radix_bits,
        probe=jidx.probe, overflow_pid=jidx.overflow_pid,
        key_spec=jidx.key_spec, epoch=jidx.epoch,
        shape_epoch=jidx.shape_epoch)


def _queries(part, x, y, qn=12, seed=5):
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), qn)
    qx, qy = x[ix], y[ix]
    rects = ds.random_rects(qn, 1e-3, part.bounds, seed=seed,
                            centers=(x, y))
    polys, ne = ds.random_polygons(6, part.bounds, seed=seed + 1)
    r = np.full(qn, 0.03, np.float32)
    return qx, qy, rects, polys, ne, r


SWEEP = [
    ("point", "PointQuery", {}, "pt"),
    ("range_count", "RangeCount", {}, "rect"),
    ("range", "RangeQuery", {}, "rect"),
    ("circle", "CircleQuery", {}, "circle"),
    ("circle_mat", "CircleQuery", {"materialize": True}, "circle"),
    ("knn", "Knn", {"k": 7}, "pt"),
    ("knn_exact", "Knn", {"k": 7, "mode": "exact"}, "pt"),
    ("join", "SpatialJoin", {}, "poly"),
    ("join_full", "SpatialJoin", {"mode": "full"}, "poly"),
]


def _args(kind, q):
    qx, qy, rects, polys, ne, r = q
    return {"pt": (qx, qy), "rect": (rects,), "circle": (qx, qy, r),
            "poly": (polys, ne)}[kind]


def _ids(row):
    return {int(v) for v in np.asarray(row) if v >= 0}


def check_family(jex, tex, fresh, name, cls, kw, args, strict):
    """One spec on the JAX executor, the port's mutated executor and the
    port's fresh build: the port bitwise the JAX executor; counts, kNN
    distances and id order bitwise the fresh build, materialized ids
    equal as sets."""
    want = jex.run(getattr(J, cls)(**kw), *args, strict=strict)
    got = tex.run(getattr(T, cls)(**kw), *args, strict=strict)
    assert_same(want, got, (name, strict, "vs JAX"))
    ref = fresh.run(getattr(T, cls)(**kw), *args, strict=strict)
    got, ref = _leaves(got), _leaves(ref)
    if name in ("range", "circle_mat"):
        assert_same(got[0], ref[0], (name, strict, "counts vs fresh"))
        for i in range(got[0].shape[0]):
            assert _ids(got[1][i]) == _ids(ref[1][i]), (name, i)
        assert bool(got[2].all()) == bool(ref[2].all())
    else:
        assert_same(ref, got, (name, strict, "vs fresh"))


@pytest.fixture(scope="module")
def mutated():
    """One insert/delete interleaving through both executors, plus the
    equivalent point set (originals - deleted + surviving inserts, in vid
    order) for the fresh builds."""
    x, y = ds.make("gaussian", N, seed=7)
    jpart = J.fit("kdtree", x, y, 8, seed=0)
    part = T.fit("kdtree", x, y, 8, seed=0)
    jex = J.Executor(J.build_index(x, y, jpart))
    tex = T.Executor(T.build_index(x, y, part, **CPU), **CPU)

    rng = np.random.default_rng(3)
    ins_x, ins_y = ds.make("gaussian", N_INS, seed=11)
    jv = jex.run(J.InsertBatch(), ins_x, ins_y)
    tv = tex.run(T.InsertBatch(), ins_x, ins_y)
    assert_same(jv, tv, "insert vids")
    assert tv.tolist() == list(range(N, N + N_INS))

    del_ix = rng.choice(N, N_DEL, replace=False)
    # delete originals AND a slice of the still-buffered inserts
    dxs = np.concatenate([x[del_ix], ins_x[:50]])
    dys = np.concatenate([y[del_ix], ins_y[:50]])
    assert jex.run(J.DeleteBatch(), dxs, dys) == N_DEL + 50
    assert tex.run(T.DeleteBatch(), dxs, dys) == N_DEL + 50
    assert_leaves(jex.index, tex.index)

    keep = np.ones(N, bool)
    keep[del_ix] = False
    ax = np.concatenate([x[keep], ins_x[50:]])
    ay = np.concatenate([y[keep], ins_y[50:]])
    avid = np.concatenate([np.arange(N)[keep],
                           np.arange(N + 50, N + N_INS)])
    return dict(x=x, y=y, part=part, jex=jex, tex=tex, ax=ax, ay=ay,
                avid=avid, ins=(ins_x, ins_y), deleted=(x[del_ix], y[del_ix]))


def _fresh(m):
    return T.Executor(T.build_index(m["ax"], m["ay"], m["part"],
                                    vid=m["avid"], n_pad=m["tex"].index.n_pad,
                                    **CPU), **CPU)


# -- pre-refit: delta-aware scans stay exact ------------------------------

def test_prerefit_counts_and_sets_match_fresh_build(mutated):
    m = mutated
    jex, tex = m["jex"], m["tex"]
    fresh = _fresh(m)
    q = _queries(m["part"], m["x"], m["y"])
    for name, cls, kw, kind in SWEEP:
        check_family(jex, tex, fresh, name, cls, kw, _args(kind, q), True)

    # membership: live inserts found, deleted points gone
    ins_x, ins_y = m["ins"]
    dx, dy = m["deleted"]
    px = np.concatenate([ins_x[50:60], ins_x[:10], dx[:10]])
    py = np.concatenate([ins_y[50:60], ins_y[:10], dy[:10]])
    got = tex.run(T.PointQuery(), px, py).numpy()
    assert_same(jex.run(J.PointQuery(), px, py), got, "membership")
    assert got[:10].all()                # live buffered inserts
    assert not got[10:].any()            # deleted inserts + originals


# -- refit: targeted, counted, eps-verified -------------------------------

def test_refit_touches_only_touched_partitions(mutated):
    m = mutated
    jex, tex = m["jex"], m["tex"]
    idx = tex.index
    dirty = [int(p) for p in np.nonzero(
        (idx.delta_count.numpy() > 0) | (idx.dead.numpy() > 0))[0]]
    assert len(dirty) >= 2
    k = dirty[: len(dirty) // 2]
    rest = [p for p in dirty if p not in k]
    gen0 = idx.refit_gen.numpy().copy()
    before = {n: getattr(idx, n).clone() for n in
              ("key", "x", "y", "vid", "knot_keys", "knot_pos",
               "radix_table", "delta_x")}
    epoch0 = idx.epoch

    assert sorted(tex.refit(k)) == sorted(k)
    assert sorted(jex.refit(k)) == sorted(k)
    idx = tex.index
    assert_leaves(jex.index, idx)
    gen1 = idx.refit_gen.numpy()
    assert (gen1[k] == gen0[k] + 1).all()
    untouched = [p for p in range(idx.num_partitions) if p not in k]
    assert (gen1[untouched] == gen0[untouched]).all()
    # untouched partitions' rows and learned model are preserved bitwise
    for n, a in before.items():
        assert torch.equal(getattr(idx, n)[untouched], a[untouched]), n
    assert idx.epoch == epoch0 + 1
    assert (idx.delta_count.numpy()[k] == 0).all()
    assert (idx.dead.numpy()[k] == 0).all()

    # the eps bound per touched partition: the re-fit spline honours the
    # corridor's 2*eps interpolation bound, as the reference's does
    for p in k:
        err = TM.verify_eps(idx, p)
        assert err == JM.verify_eps(jex.index, p), p
        assert err <= 2 * idx.eps + 1, (p, err)

    # finish compaction for the downstream parity tests
    tex.refit(rest)
    jex.refit(rest)
    assert (tex.index.refit_gen.numpy()[rest] == gen0[rest] + 1).all()
    assert_leaves(jex.index, tex.index)


# -- post-refit: bitwise parity, every spec, both modes -------------------

def test_postrefit_bitwise_parity_all_specs(mutated):
    m = mutated
    jex, tex = m["jex"], m["tex"]
    tex.refit()        # idempotent if the previous test already ran
    jex.refit()
    assert_leaves(jex.index, tex.index)
    fresh = _fresh(m)
    q = _queries(m["part"], m["x"], m["y"])
    for strict in (True, False):
        for name, cls, kw, kind in SWEEP:
            want = fresh.run(getattr(T, cls)(**kw), *_args(kind, q),
                             strict=strict)
            got = tex.run(getattr(T, cls)(**kw), *_args(kind, q),
                          strict=strict)
            assert_same(want, got, (name, strict, "vs fresh"))
            assert_same(jex.run(getattr(J, cls)(**kw), *_args(kind, q),
                                strict=strict), got, (name, strict, "vs JAX"))
    # the re-fit rows are the fresh build's, bit for bit
    for n in ("key", "x", "y", "vid", "count", "n_knots", "radix_table"):
        assert torch.equal(getattr(tex.index, n),
                           getattr(fresh.index, n)), n


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16])
def test_delta_stages_in_groups_and_chunks(budget):
    """The delta probes run once per call over partition groups and row
    chunks sized by ``scan_chunk_elems``; a small budget (many groups,
    one-row chunks, the candidate-chunked circle compaction) gives the
    default budget's results bit for bit, before and after a re-fit."""
    x, y = ds.make("gaussian", 3000, seed=17)
    part = T.fit("kdtree", x, y, 20, seed=0)
    idx = T.build_index(x, y, part, **CPU)
    exs = [T.Executor(idx, **CPU),
           T.Executor(idx, T.EngineConfig(scan_chunk_elems=budget), **CPU)]
    bx, by = ds.make("gaussian", 300, seed=18)
    for ex in exs:
        ex.run(T.InsertBatch(), bx, by)
        ex.run(T.DeleteBatch(), np.concatenate([x[:80], bx[:20]]),
               np.concatenate([y[:80], by[:20]]))
    ex = exs[1]
    group = TL._LocalFn(ex.index, ex.cfg, ex.backend)._delta_group(24)
    assert group < ex.index.num_partitions   # 24: groups of 8, or 16 + 8
    q = _queries(part, x, y, qn=24, seed=19)
    for refit in (False, True):
        if refit:
            for ex in exs:
                ex.refit()
        for name, cls, kw, kind in SWEEP:
            want, got = (ex.run(getattr(T, cls)(**kw), *_args(kind, q),
                                strict=True) for ex in exs)
            assert_same(want, got, (name, refit, budget))


# -- counters, capacity, domain -------------------------------------------

def test_epoch_counters_track_updates():
    x, y = ds.make("gaussian", 2000, seed=31)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=128))
    tex = T.Executor(T.build_index(x, y, T.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=128, **CPU), **CPU)
    assert tex.index.epoch == 0 and tex.epoch == 0
    bx, by = ds.make("gaussian", 32, seed=32)
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), bx, by)
        assert ex.index.epoch == 1
        assert ex.run(M.DeleteBatch(), bx[:8], by[:8]) == 8
        assert ex.index.epoch == 2
        ex.run(M.Refit())
        assert ex.index.epoch == 3
    st, js = tex.stats(), jex.stats()
    assert st["updates"] == 2 and st["refits"] == 1
    for key in ("host_syncs", "probe_syncs", "dispatches", "cache_size",
                "qshard_executables", "disk_cache_hits",
                "disk_cache_misses", "async_compiles", "sticky", "epoch",
                "shape_epoch", "updates", "refits", "pending_refit"):
        assert st[key] == js[key], key
    # the reference's 16 keys, and the port's one more: the precompile
    # worker's failed captures
    assert set(st) == set(js) | {"async_capture_errors"} and len(st) == 17
    assert st["async_capture_errors"] == 0
    assert not tex.maintenance_due() and not jex.maintenance_due()
    assert_leaves(jex.index, tex.index)


def test_capacity_growth_bumps_shape_epoch():
    """An insert that overflows the delta capacity grows it (a static
    shape change, so shape_epoch bumps) and queries stay exact."""
    x, y = ds.make("gaussian", 3000, seed=25)
    part = T.fit("kdtree", x, y, 4, seed=0)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0)),
                     config=J.EngineConfig(delta_cap=64))
    tex = T.Executor(T.build_index(x, y, part, **CPU),
                     T.EngineConfig(delta_cap=64), **CPU)
    rects = ds.random_rects(8, 1e-3, part.bounds, seed=26, centers=(x, y))
    assert_same(jex.run(J.RangeCount(), rects), tex.run(T.RangeCount(), rects))
    se0 = tex.index.shape_epoch
    assert se0 == jex.index.shape_epoch == 0
    bx, by = ds.make("gaussian", 300, seed=27)
    jex.run(J.InsertBatch(), bx, by)
    assert all(k[5] == se0 for k in tex.cache_keys())
    tex.run(T.InsertBatch(), bx, by)     # overflows delta_cap=64: grow
    assert tex.index.shape_epoch > se0
    assert tex.index.shape_epoch == jex.index.shape_epoch
    assert tex.index.delta_cap == jex.index.delta_cap
    assert_leaves(jex.index, tex.index)
    # the stale-epoch sweep leaves no program of the old shapes
    assert all(k[5] == tex.index.shape_epoch for k in tex.cache_keys())
    assert cache_keys(jex) == set(tex.cache_keys())
    fresh = T.Executor(T.build_index(
        np.concatenate([x, bx]), np.concatenate([y, by]), part,
        n_pad=tex.index.n_pad, **CPU), **CPU)
    got = tex.run(T.RangeCount(), rects)
    assert_same(fresh.run(T.RangeCount(), rects), got, "post-growth")
    assert_same(jex.run(J.RangeCount(), rects), got, "post-growth vs JAX")


def cache_keys(jex) -> set:
    """The JAX executor's program-cache keys, xla named torch."""
    return {(("torch",) if k[0] == "xla" else (k[0],)) + k[1:]
            for k in jex.cache_keys()}


def test_update_executables_cache_like_queries():
    """Equal-shape inserts reuse one cached update program: the cache
    neither grows nor changes, and holds the JAX Executor's keys."""
    x, y = ds.make("gaussian", 3000, seed=21)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=512))
    tex = T.Executor(T.build_index(x, y, T.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=512, **CPU), **CPU)
    b1x, b1y = ds.make("gaussian", 64, seed=22)
    b2x, b2y = ds.make("gaussian", 64, seed=23)
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), b1x, b1y)
    n0 = tex.stats()["cache_size"]
    keys0 = set(tex.cache_keys())
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), b2x, b2y)   # same shapes: cached program
    assert tex.stats()["cache_size"] == n0 == jex.stats()["cache_size"]
    assert set(tex.cache_keys()) == keys0 == cache_keys(jex)
    assert any(k[3] == "u" and k[2] == ("insert",)
               for k in tex.cache_keys())
    assert_leaves(jex.index, tex.index)


def test_out_of_domain_inserts_visible_to_all_queries():
    """Inserts outside the build-time bounds land in the overflow grid;
    its box widens so the global filter (range, circle and kNN
    candidates) sees them, not only the point probe."""
    x, y = ds.make("gaussian", 2000, seed=51)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=64))
    tex = T.Executor(T.build_index(x, y, T.fit("kdtree", x, y, 4, seed=0),
                                   delta_cap=64, **CPU), **CPU)
    ox = np.asarray([5.0, 5.1], np.float32)
    oy = np.asarray([5.0, 5.1], np.float32)
    rect = np.asarray([[4.9, 4.9, 5.2, 5.2]], np.float32)
    r = np.asarray([0.5], np.float32)
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), ox, oy)
    assert_leaves(jex.index, tex.index)
    for refit in (False, True):
        if refit:
            jex.refit()
            tex.refit()
        for spec, args in (("PointQuery", (ox, oy)), ("RangeCount", (rect,)),
                           ("CircleQuery", (ox[:1], oy[:1], r))):
            want = jex.run(getattr(J, spec)(), *args, strict=True)
            got = tex.run(getattr(T, spec)(), *args, strict=True)
            assert_same(want, got, (spec, refit))
        assert tex.run(T.PointQuery(), ox, oy).all()
        assert int(tex.run(T.RangeCount(), rect)[0]) == 2
        d2, vid = tex.run(T.Knn(k=2), ox[:1], oy[:1], strict=True)
        assert_same(jex.run(J.Knn(k=2), ox[:1], oy[:1], strict=True),
                    (d2, vid), ("knn", refit))
        assert set(vid[0].tolist()) == {2000, 2001}


def test_serve_session_mutations_and_maintain_refit():
    x, y = ds.make("gaussian", 2000, seed=41)
    part = T.fit("kdtree", x, y, 4, seed=0)
    cfg = dict(delta_cap=64, delta_occupancy=0.01)
    js = JSession(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0)),
                  config=J.EngineConfig(**cfg))
    ts = TSession(T.build_index(x, y, part, **CPU), T.EngineConfig(**cfg),
                  **CPU)
    rects = ds.random_rects(6, 1e-3, part.bounds, seed=42, centers=(x, y))
    assert_same(js.submit(J.RangeCount(), rects),
                ts.submit(T.RangeCount(), rects))
    bx, by = ds.make("gaussian", 100, seed=43)
    assert_same(js.insert(bx, by), ts.insert(bx, by), "insert vids")
    # tiny occupancy threshold: the insert scheduled a deferred re-fit
    assert ts.stats()["pending_refit"]
    assert ts.stats()["pending_refit"] == js.stats()["pending_refit"]
    assert ts.executor.maintenance_due()
    moved = ts.maintain()
    assert moved == js.maintain()
    assert moved.get("refit")
    assert not ts.stats()["pending_refit"]
    assert ts.executor.refits == 1
    assert_leaves(js.executor.index, ts.executor.index)
    # post-compaction results bitwise match a fresh build
    fresh = T.Executor(T.build_index(
        np.concatenate([x, bx]), np.concatenate([y, by]), part,
        n_pad=ts.executor.index.n_pad, **CPU), **CPU)
    got = ts.submit(T.RangeCount(), rects)
    assert_same(fresh.run(T.RangeCount(), rects), got, "serve vs fresh")
    assert_same(js.submit(J.RangeCount(), rects), got, "serve vs JAX")
    assert ts.delete(bx[:5], by[:5]) == js.delete(bx[:5], by[:5]) == 5
    assert_same(js.submit(J.RangeCount(), rects),
                ts.submit(T.RangeCount(), rects), "after delete")


# -- each mutate step against the reference's ------------------------------

@pytest.fixture(scope="module")
def dirty_jax_index():
    """A JAX index with buffered inserts (some deleted again) and
    tombstones, for the step-parity cases."""
    x, y = jds.make("uniform", 3000, seed=61)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 5, seed=0)))
    bx, by = jds.make("uniform", 300, seed=62)
    # a few repeated coordinates: duplicates in the main plane and delta
    bx[:20], by[:20] = x[:20], y[:20]
    bx[20:30], by[20:30] = bx[30:40], by[30:40]
    jex.run(J.InsertBatch(), bx, by)
    jex.run(J.DeleteBatch(), np.concatenate([x[100:160], bx[200:230]]),
            np.concatenate([y[100:160], by[200:230]]))
    return jex.index, x, y, bx, by


def _np(a):
    return np.asarray(a).astype(np.int64) if np.asarray(a).dtype == \
        np.uint32 else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.array(_np(a)))


@pytest.mark.parametrize("step", ["scatter_inserts", "apply_deletes",
                                  "merge_rows", "refit_partitions",
                                  "row_max_runs", "delta_capacity"])
def test_mutate_step_matches_reference(dirty_jax_index, step):
    import jax.numpy as jnp
    jidx, x, y, bx, by = dirty_jax_index
    tidx = to_port(jidx)
    assert_leaves(jidx, tidx)
    rng = np.random.default_rng(63)
    if step == "scatter_inserts":
        # room for the batch (the caller guarantees the capacity)
        jidx = JM.with_delta_capacity(jidx, 512)
        tidx = TM.with_delta_capacity(tidx, 512)
        cx, cy = jds.make("uniform", 150, seed=64)
        pid = np.asarray(JM.assign_insert(jidx, jnp.asarray(cx),
                                          jnp.asarray(cy)))
        assert_same(pid.astype(np.int64),
                    TM.assign_insert(tidx, _t(cx), _t(cy)), "pid")
        key = np.asarray(J.make_keys(jnp.asarray(cx), jnp.asarray(cy),
                                     jidx.key_spec))
        vids = np.arange(9000, 9150, dtype=np.int32)
        want = JM.scatter_inserts(jidx.delta_key, jidx.delta_x, jidx.delta_y,
                                  jidx.delta_vid, jidx.delta_count,
                                  jnp.asarray(pid), jnp.asarray(key),
                                  jnp.asarray(cx), jnp.asarray(cy),
                                  jnp.asarray(vids))
        got = TM.scatter_inserts(
            tidx.delta_key, tidx.delta_x, tidx.delta_y, tidx.delta_vid,
            tidx.delta_count, _t(pid), _t(key), _t(cx), _t(cy), _t(vids))
        assert_same(tuple(_np(w) for w in want), got, step)
    elif step == "apply_deletes":
        # live originals, tombstoned ones, buffered inserts (one
        # coordinate held twice), misses, and repeated queries
        qx = np.concatenate([x[150:200], bx[10:40], bx[220:225],
                             rng.random(5).astype(np.float32), x[160:165]])
        qy = np.concatenate([y[150:200], by[10:40], by[220:225],
                             rng.random(5).astype(np.float32), y[160:165]])
        p1 = JM.assign_insert(jidx, jnp.asarray(qx), jnp.asarray(qy))
        p2 = jnp.full_like(p1, jidx.overflow)
        want = JM.apply_deletes(
            jidx.x, jidx.y, jidx.vid, jidx.count, jidx.delta_x,
            jidx.delta_y, jidx.delta_vid, jidx.delta_count, jidx.dead,
            jnp.asarray(qx), jnp.asarray(qy), p1, p2)
        got = TM.apply_deletes(
            tidx.x, tidx.y, tidx.vid, tidx.count, tidx.delta_x,
            tidx.delta_y, tidx.delta_vid, tidx.delta_count, tidx.dead,
            _t(qx), _t(qy), _t(p1).long(), _t(p2).long())
        assert int(got[-1]) > 0
        assert_same(tuple(_np(w) for w in want), got, step)
    elif step == "merge_rows":
        t = np.asarray([0, 2, 3, 5])
        names = ("key", "x", "y", "vid", "count", "delta_key", "delta_x",
                 "delta_y", "delta_vid", "delta_count")
        want = JM.merge_rows(*(getattr(jidx, n)[t] for n in names),
                             sentinel=jidx.key_spec.sentinel)
        got = TM.merge_rows(*(getattr(tidx, n)[torch.as_tensor(t)]
                              for n in names),
                            sentinel=tidx.key_spec.sentinel)
        assert_same(tuple(_np(w) for w in want), got, step)
    elif step == "refit_partitions":
        for touched in ([1, 4], list(range(jidx.num_partitions))):
            assert_leaves(JM.refit_partitions(jidx, touched),
                          TM.refit_partitions(tidx, touched))
        assert JM.dirty_partitions(jidx).tolist() == \
            TM.dirty_partitions(tidx).tolist()
        assert JM.delta_occupancy(jidx).tobytes() == \
            TM.delta_occupancy(tidx).tobytes()
    elif step == "row_max_runs":
        assert_same(JM.row_max_runs(jidx.key, jidx.count),
                    TM.row_max_runs(tidx.key, tidx.count), step)
    else:
        grown = (JM.with_delta_capacity(jidx, 700),
                 TM.with_delta_capacity(tidx, 700))
        assert_leaves(*grown)
        full = (JM.refit_partitions(grown[0], JM.dirty_partitions(jidx)),
                TM.refit_partitions(grown[1], TM.dirty_partitions(tidx)))
        assert_leaves(JM.shrink_delta_capacity(full[0], 64),
                      TM.shrink_delta_capacity(full[1], 64))


# -- the two findings measured on the reference ----------------------------

def _denormal_pair():
    """Uniform points plus one at (1e-45, 0.5), built by both packages
    (kdtree 4), and a buffered insert at (-1e-45, 0.25)."""
    x, y = jds.make("uniform", 1500, seed=71)
    x = np.concatenate([x, np.float32([1e-45])]).astype(np.float32)
    y = np.concatenate([y, np.float32([0.5])]).astype(np.float32)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0)))
    tex = T.Executor(T.build_index(x, y, T.fit("kdtree", x, y, 4, seed=0),
                                   **CPU), **CPU)
    return x, y, jex, tex


def test_denormal_deletes_match_reference():
    """A delete compares with denormals read as zero, as XLA:CPU does: a
    point built at (1e-45, 0.5) and a buffered insert at (-1e-45, 0.25)
    are both removed by deletes at x = 0.0 (an exact compare removes
    neither: the stored coordinates are the denormals)."""
    x, y, jex, tex = _denormal_pair()
    ix, iy = np.float32([-1e-45, 0.7]), np.float32([0.25, 0.7])
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), ix, iy)
    assert_leaves(jex.index, tex.index)
    assert (tex.index.x == np.float32(1e-45)).any()
    assert (tex.index.delta_x == np.float32(-1e-45)).any()
    dx, dy = np.float32([0.0, 0.0]), np.float32([0.5, 0.25])
    assert jex.run(J.DeleteBatch(), dx, dy) == 2
    assert tex.run(T.DeleteBatch(), dx, dy) == 2
    assert_leaves(jex.index, tex.index)
    for refit in (False, True):
        if refit:
            assert jex.refit() == tex.refit()
            assert_leaves(jex.index, tex.index)
        qx = np.float32([1e-45, 0.0, -1e-45, 0.7])
        qy = np.float32([0.5, 0.5, 0.25, 0.7])
        for cls, kw, args in (
                ("PointQuery", {}, (qx, qy)),
                ("RangeCount", {}, (np.float32([[-0.01, 0.2, 0.01, 0.6]]),)),
                ("Knn", {"k": 3}, (qx, qy)),
                ("Knn", {"k": 3, "mode": "exact"}, (qx, qy))):
            assert_same(jex.run(getattr(J, cls)(**kw), *args, strict=True),
                        tex.run(getattr(T, cls)(**kw), *args, strict=True),
                        (cls, kw, refit))
        found = tex.run(T.PointQuery(), qx, qy)
        assert found.tolist() == [False, False, False, True]


def test_knn_with_fewer_live_points_than_k():
    """300 points, 297 deleted: exact and pruned 5-NN end in (3e38, -1)
    padding on both packages (padding outranks the tombstones, whose d^2
    overflows to +inf), before and after the re-fit."""
    x, y = ds.make("gaussian", 300, seed=81)
    jex = J.Executor(J.build_index(x, y, J.fit("kdtree", x, y, 4, seed=0)))
    tex = T.Executor(T.build_index(x, y, T.fit("kdtree", x, y, 4, seed=0),
                                   **CPU), **CPU)
    for ex, M in ((jex, J), (tex, T)):
        assert ex.run(M.DeleteBatch(), x[3:], y[3:]) == 297
    qx, qy = x[:6], y[:6]
    for refit in (False, True):
        if refit:
            jex.refit()
            tex.refit()
        for mode in ("exact", "pruned"):
            want = jex.run(J.Knn(k=5, mode=mode), qx, qy, strict=True)
            got = tex.run(T.Knn(k=5, mode=mode), qx, qy, strict=True)
            assert_same(want, got, (mode, refit))
            d2, vid = got
            assert (vid[:, 3:] == -1).all() and (vid[:, :3] >= 0).all()
            assert (d2[:, 3:] == np.float32(3e38)).all()


# -- re-fits that grow the statics -----------------------------------------

def _grow_case(extra_distinct: int, dup: int, eps: int, n_pad=None):
    """Both packages on uniform 2000 points (kdtree 4, ``eps``, ``n_pad``),
    then ``extra_distinct`` inserts inside partition 0's box and ``dup``
    inserts at one coordinate there, re-fit. Returns the two executors,
    the port's index before the re-fit and the fresh port build."""
    x, y = jds.make("uniform", 2000, seed=91)
    jp = J.fit("kdtree", x, y, 4, seed=0)
    tp = T.fit("kdtree", x, y, 4, seed=0)
    jex = J.Executor(J.build_index(x, y, jp, eps=eps, n_pad=n_pad))
    tex = T.Executor(T.build_index(x, y, tp, eps=eps, n_pad=n_pad, **CPU),
                     **CPU)
    box = tp.partition_bounds()[0]
    rng = np.random.default_rng(92)
    bx = (box[0] + (box[2] - box[0]) * rng.random(extra_distinct)
          ).astype(np.float32)
    by = (box[1] + (box[3] - box[1]) * rng.random(extra_distinct)
          ).astype(np.float32)
    bx = np.concatenate([bx, np.full(dup, bx[0], np.float32)])
    by = np.concatenate([by, np.full(dup, by[0], np.float32)])
    for ex, M in ((jex, J), (tex, T)):
        ex.run(M.InsertBatch(), bx, by)
    before = tex.index
    assert jex.refit() == tex.refit()
    assert_leaves(jex.index, tex.index)
    fresh = T.Executor(T.build_index(
        np.concatenate([x, bx]), np.concatenate([y, by]), tp, eps=eps,
        n_pad=tex.index.n_pad, **CPU), **CPU)
    q = _queries(tp, np.concatenate([x, bx]), np.concatenate([y, by]),
                 qn=8, seed=93)
    for name, cls, kw, kind in SWEEP[:2] + SWEEP[5:7]:
        check_family(jex, tex, fresh, name, cls, kw, _args(kind, q), True)
    return jex, tex, before, fresh


def test_refit_grows_knot_width_and_probe():
    """Many inserts at one coordinate lengthen a duplicate run past the
    probe, and dense distinct inserts at eps 2 need more knots than the
    knot width holds: the re-fit doubles the width and widens the probe
    (the data plane, built at n_pad 4096, has room), each a shape_epoch
    bump, as the reference's."""
    jex, tex, before, _ = _grow_case(2000, 1500, eps=2, n_pad=4096)
    idx = tex.index
    assert idx.knot_keys.shape[1] > before.knot_keys.shape[1]
    assert idx.probe > before.probe
    assert idx.n_pad == before.n_pad
    assert idx.shape_epoch >= before.shape_epoch + 2


def test_refit_grows_n_pad():
    """Merged rows longer than n_pad widen the data plane to the next
    multiple of 128 (a shape_epoch bump) and stay the fresh build's."""
    jex, tex, before, fresh = _grow_case(900, 0, eps=32)
    idx = tex.index
    assert idx.n_pad > before.n_pad and idx.n_pad % 128 == 0
    assert idx.shape_epoch > before.shape_epoch
    for n in ("key", "x", "y", "vid", "count"):
        assert torch.equal(getattr(idx, n), getattr(fresh.index, n)), n


# -- sharded updates: a (2, 2) mesh of four gloo ranks ---------------------

SHARDED_STEPS = ("ins0_", "ins_", "del_", "refit_")
SHARDED_STATS = ("epoch", "shape_epoch", "delta_cap", "n_pad", "next_vid",
                 "pending_refit", "updates", "refits")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import _dist_worker as W
    # one spawn with test_torch_query_shard.py's scenario
    ref, ranks = W.spawn_once(W.MESH_2X2DQ, ("2x2dq",),
                              tmp_path_factory)()["2x2dq"]
    return W, ref, ranks


def test_sharded_updates_ranks_agree(sharded):
    _, _, ranks = sharded
    for d in ranks[1:]:
        assert set(d) == set(ranks[0])
        for k in d:
            assert np.array_equal(d[k], ranks[0][k]), k


@pytest.mark.parametrize("step", SHARDED_STEPS)
def test_sharded_updates_agree_with_reference_statics(sharded, step):
    """Each step's epochs and statics: the reference's at the mesh and
    the unsharded reference's (after the second insert the capacity has
    grown; after the re-fit n_pad and the probe have)."""
    _, ref, ranks = sharded
    for k in SHARDED_STATS:
        got = ranks[0][f"{step}stats/{k}"]
        assert np.array_equal(got, ref[f"{step}stats/{k}"]), (step, k)
        if f"plain_{step}stats/{k}" in ref and k not in ("refits",):
            assert np.array_equal(got, ref[f"plain_{step}stats/{k}"]), \
                (step, k)
    if step == "ins_":
        assert ranks[0]["ins_stats/delta_cap"] > ranks[0]["ins0_stats/delta_cap"]
    if step == "refit_":
        assert ranks[0]["refit_stats/n_pad"] > ranks[0]["del_stats/n_pad"]


def test_sharded_updates_vids_removed_and_refit(sharded):
    W, ref, ranks = sharded
    for k in ("vids0", "vids", "removed", "refit"):
        assert W.same((ranks[0][k],), (ref[k],)), k
    assert int(ranks[0]["removed"]) == 120


@pytest.mark.parametrize("when", ["pre", "post"])
def test_sharded_updates_outputs_match_reference(sharded, when):
    W, ref, ranks = sharded
    names = [k[len(when) + 1:-2] for k in ranks[0]
             if k.startswith(when + "/") and k.endswith("/0")]
    assert len(names) == len(W.UPDATE_FAMILIES)
    for name in names:
        got = W.outputs(ranks[0], f"{when}/{name}")
        want = W.outputs(ref, f"{when}/{name}")
        assert want is not None, ref[f"{when}/{name}/raised"]
        assert W.same(got, want), (when, name)
