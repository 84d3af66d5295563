"""The precompile worker and the scheduler's warm-width handoff
(DESIGN.md §14, async precompilation), against the JAX package on the
CPU (xla backend, seeded numpy inputs).

Ported from tests/test_compile_cache.py:
``test_async_precompile_is_bitwise_neutral``: three client threads
through a worker-mode scheduler with the precompile worker on; every
ticket bitwise the port's serial ``submit`` and the JAX session's, and
the worker stopped by ``close()``.

Added:

  handoff      the precompiler started by hand on both executors, the
               schedulers in drain mode, batches whose totals cross
               several power-of-two widths: the ``events`` (each batch's
               width), ``width_fallbacks``, ``precompile_pending``,
               ``async_compiles``, ``cache_keys()`` and the tickets equal
               between the packages;
  neighbours   a sticky move through ``maintain()`` (an escalation, then
               a demotion): after quiesce ``cache_variants(base)`` equals
               the JAX Executor's and holds the tiers above and below
               the sticky one as fused programs;
  neutrality   after quiesce a steady dispatch of each warmed (spec,
               width) realizes nothing new, for every query family:
               ``_warm_targets`` derives, from the shapes alone, the
               signatures the steady path realizes;
  life cycle   a capacity-growing insert clears the scheduler's warm
               widths and pending labels; a job of an old shape epoch
               installs nothing; ``start_precompiler`` is idempotent; a
               failing job is swallowed (a capture failure counted in
               ``async_capture_errors``) and its label marked done;
               ``stop_precompiler`` joins its thread.

On the CPU a realization is the program itself (no CUDA graph), so, as
in the reference, every dispatch makes its width warm. The card's side
(captures on the worker, launch counts under two threads, the capture
lock) is in tests/test_torch_gpu.py.
"""
import threading

import numpy as np
import pytest
import torch

from repro import core as J
from repro.serve import SpatialServeSession as JSession
from repro_torch import core as T
from repro_torch.core.executor import GraphCaptureError
from repro_torch.data import spatial as ds
from repro_torch.serve import SpatialServeSession as TSession

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

N = 3000
PARTS = 12
CPU = dict(device="cpu")
SPEC_NAMES = ("point", "range_count", "range", "circle", "circle_mat",
              "knn5", "join")
# every spec measured wide: each coalesces to serve_max_batch
BENCH = {"bench_q": 16, "bench_q_wide": 256,
         "specs": {n: {"steady_us_per_q": 10.0,
                       "steady_us_per_q_b256": 5.0} for n in SPEC_NAMES}}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


def assert_same(a, b, what=""):
    """Bitwise equality of two results (JAX, port, numpy or int)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for u, v in zip(la, lb):
        u, v = _np(u), _np(v)
        assert u.dtype == v.dtype and u.shape == v.shape, what
        assert u.tobytes() == v.tobytes(), what


def port_keys(keys) -> set:
    """Program-cache keys with the JAX backend's name mapped (xla is the
    port's torch backend)."""
    return {(("torch",) if k[0] == "xla" else (k[0],)) + tuple(k[1:])
            for k in keys}


def sig_state(ex) -> dict:
    """{exec_key: realized signatures} of a port executor."""
    return {k: d.sigs() for k, d in ex._cache.items()}


@pytest.fixture(scope="module")
def built():
    x, y = ds.make("gaussian", N, seed=5)
    return (x, y, J.fit("kdtree", x, y, PARTS, seed=0),
            J.build_index(x, y, J.fit("kdtree", x, y, PARTS, seed=0)),
            T.build_index(x, y, T.fit("kdtree", x, y, PARTS, seed=0),
                          **CPU))


def _requests(x, y, bounds, n, seed, M):
    """n rows per family as ``M``'s (spec, *args): every query family."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), n)
    qx, qy = x[ix], y[ix]
    rects = ds.random_rects(n, 1e-3, bounds, seed=seed + 1, centers=(x, y))
    polys, ne = ds.random_polygons(n, bounds, seed=seed + 2)
    r = np.full(n, 0.03, np.float32)
    return {"point": (M.PointQuery(), qx, qy),
            "range_count": (M.RangeCount(), rects),
            "range": (M.RangeQuery(), rects),
            "circle": (M.CircleQuery(), qx, qy, r),
            "circle_mat": (M.CircleQuery(materialize=True), qx, qy, r),
            "knn": (M.Knn(k=5), qx, qy),
            "knn_exact": (M.Knn(k=4, mode="exact"), qx, qy),
            "join": (M.SpatialJoin(), polys, ne),
            "join_full": (M.SpatialJoin(mode="full"), polys, ne)}


def _sessions(built, **cfg):
    x, y, part, jidx, tidx = built
    js = JSession(jidx, config=J.EngineConfig(backend="xla", **cfg))
    ts = TSession(tidx, config=T.EngineConfig(backend="torch", **cfg),
                  **CPU)
    return js, ts


def _drain_held(sched):
    """Drain with the precompile worker held until the drain is done, so
    each width handed over runs after its own dispatch, in both
    packages (else which thread realizes a width first is a race), then
    quiesce."""
    gate = threading.Event()
    sched.ex._pc_submit(("hold", id(gate)), lambda: gate.wait() and 0)
    try:
        sched.drain()
    finally:
        gate.set()
    assert sched.ex.precompile_quiesce(120.0)


def _settle(js, ts, x, y, bounds):
    """Sticky tiers settled on both sessions (strict, then steady)."""
    for M, s in ((J, js), (T, ts)):
        s.warmup(list(_requests(x, y, bounds, 4, 90, M).values()))


# -- tests/test_compile_cache.py ------------------------------------------

def test_async_precompile_is_bitwise_neutral(built):
    x, y, part = built[:3]
    js, ts = _sessions(built, serve_async_precompile=True)
    ix = np.random.default_rng(21).integers(0, len(x), 12)
    specs = [(x[i:i + 1], y[i:i + 1]) for i in ix]
    jref = [js.submit(J.PointQuery(), *a) for a in specs]
    tref = [ts.submit(T.PointQuery(), *a) for a in specs]
    with ts.scheduler(start=True) as live:
        assert live.ex.precompiling
        tickets = [None] * len(specs)

        def client(k):
            for i in range(k, len(specs), 3):
                tickets[i] = live.submit(T.PointQuery(), *specs[i])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        got = [t.result(120.0) for t in tickets]
        assert live.ex.precompile_quiesce(120.0)
        st = live.stats()
    assert st["maintain_busy"] == 0
    for i, (g, t, j) in enumerate(zip(got, tref, jref)):
        assert_same(g, t, f"request {i}: async precompilation changed a "
                    "result bit")
        assert_same(g, j, f"request {i}: port vs JAX")
    # the worker never runs afterwards: close() stopped it
    assert not ts.executor.precompiling
    assert ts.stats()["async_capture_errors"] == 0


# -- the handoff against the JAX scheduler ---------------------------------

def test_handoff_matches_jax_scheduler(built):
    """Drain mode with the precompiler started by hand on both
    executors: every batch of the totals 1, 3, 5, 17, 2, 9 per family
    is handed over, a width with a larger warm one pads to it (17 -> 32
    runs the bucketed dispatch), and the counters, events, program
    cache and tickets agree with the JAX scheduler's after each
    drain and quiesce."""
    x, y, part = built[:3]
    js, ts = _sessions(built)
    _settle(js, ts, x, y, part.bounds)
    jsched = js.scheduler(bench=BENCH, start=False)
    tsched = ts.scheduler(bench=BENCH, start=False)
    assert not jsched.ex.precompiling and not tsched.ex.precompiling
    assert js.executor.start_precompiler()
    assert ts.executor.start_precompiler()
    fams = ("point", "range", "knn", "circle_mat")
    jt, tt = [], []
    try:
        for step, (total, name) in enumerate(
                (t, n) for t in (1, 3, 5, 17, 2, 9) for n in fams):
            # one family per drain, then quiesce: when the next batch
            # looks, each handed-over width is done on both packages
            for M, sched, out in ((J, jsched, jt), (T, tsched, tt)):
                spec, *args = _requests(x, y, part.bounds, total,
                                        100 + step, M)[name]
                for i in range(total):           # single-row requests
                    out.append(sched.submit(spec,
                                            *(a[i:i + 1] for a in args)))
                _drain_held(sched)
            what = f"total {total}, {name}"
            assert list(jsched.events) == list(tsched.events), what
            jst, tst = jsched.stats(), tsched.stats()
            for key in ("width_fallbacks", "precompile_pending", "reads",
                        "read_batches", "max_batch", "maintain_runs",
                        "maintain_busy"):
                assert jst[key] == tst[key], (what, key)
            assert (js.stats()["async_compiles"]
                    == ts.stats()["async_compiles"]), what
            assert port_keys(js.executor.cache_keys()) == \
                port_keys(ts.executor.cache_keys()), what
            assert js.executor._sticky == ts.executor._sticky, what
        assert len(jt) == len(tt)
        for i, (a, b) in enumerate(zip(jt, tt)):
            assert (a.epoch, a.batched) == (b.epoch, b.batched), i
            assert_same(a.result(), b.result(), f"request {i}")
        st = tsched.stats()
        # 2 -> 4 and 9 -> 32 padded to a larger warm width, per family
        widths = [e[3] for e in tsched.events if e[0] == "batch"]
        assert st["width_fallbacks"] == 2 * len(fams)
        assert widths == [w for w in (1, 4, 8, 32, 4, 32)
                          for _ in fams]
        assert ts.stats()["async_compiles"] > 0
        assert ts.stats()["async_capture_errors"] == 0
        # the last handed-over width is done, moved to warm at the next
        # batch of its family
        assert st["precompile_pending"] == 1 and all(
            ts.executor.precompile_done(lbl)
            for lbl in tsched._pc_pending.values())
    finally:
        jsched.close()
        tsched.close()
        js.executor.stop_precompiler()
        ts.executor.stop_precompiler()


# -- the neighbour handoff after a sticky move ------------------------------

def test_neighbour_tiers_warmed_after_sticky_move(built):
    """An escalation through maintain(), then a demotion: after each
    quiesce the range family's cached window variants equal the JAX
    Executor's, with the tiers above and below the sticky one cached as
    fused programs, and the steady results agree bitwise."""
    x, y, part, jidx, tidx = built
    je = J.Executor(jidx, config=J.EngineConfig(backend="xla"))
    te = T.Executor(tidx, config=T.EngineConfig(backend="torch"), **CPU)
    small = ds.random_rects(8, 1e-4, part.bounds, seed=61, centers=(x, y))
    big = ds.random_rects(8, 0.2, part.bounds, seed=62, centers=(x, y))
    base = T.RangeQuery().sticky_key()
    assert je.start_precompiler() and te.start_precompiler()
    try:
        outs = []
        for ex, M in ((je, J), (te, T)):
            ex.run(M.RangeQuery(), small, strict=True)   # sticky settles
            outs.append(ex.run(M.RangeQuery(), big))      # overflows
        assert_same(*outs)
        moves = []
        for ex in (je, te):
            moves.append(ex.maintain())
            assert ex.precompile_quiesce(120.0)
        assert moves[0] == moves[1] and base in moves[1], moves
        esc_sticky = te._sticky[base]

        def neighbours(ex):
            sticky = ex._sticky[base]
            return {("fused", ex._escalators[base](*sticky)),
                    ("fused", ex._demoters[base](*sticky))}

        assert je.cache_variants(base) == te.cache_variants(base)
        assert neighbours(te) <= set(te.cache_variants(base))
        assert je.stats()["async_compiles"] == te.stats()["async_compiles"]
        # clean checks until the tier steps back down
        for _ in range(8):
            outs = [ex.run(M.RangeQuery(), small)
                    for ex, M in ((je, J), (te, T))]
            assert_same(*outs)
            moved = [ex.maintain() for ex in (je, te)]
            assert moved[0] == moved[1]
            for ex in (je, te):
                assert ex.precompile_quiesce(120.0)
            if te._sticky[base] != esc_sticky:
                break
        assert te._sticky[base] == je._sticky[base] != esc_sticky
        assert je.cache_variants(base) == te.cache_variants(base)
        assert neighbours(te) <= set(te.cache_variants(base))
        assert port_keys(je.cache_keys()) == port_keys(te.cache_keys())
        assert je.stats()["async_compiles"] == te.stats()["async_compiles"]
    finally:
        je.stop_precompiler()
        te.stop_precompiler()


# -- neutrality: the derived signatures are the steady path's ---------------

@pytest.mark.parametrize("family", ["point", "range_count", "range",
                                    "circle", "circle_mat", "knn",
                                    "knn_exact", "join", "join_full"])
def test_warmed_width_realizes_nothing_new(built, family):
    """After the worker warmed (spec, width) and quiesced, a steady
    dispatch at that width adds no cached program and no signature, and
    answers bitwise as the JAX Executor."""
    x, y, part, jidx, tidx = built
    je = J.Executor(jidx, config=J.EngineConfig(backend="xla"))
    te = T.Executor(tidx, config=T.EngineConfig(backend="torch"), **CPU)
    for ex, M in ((je, J), (te, T)):             # sticky tiers settle
        spec, *args = _requests(x, y, part.bounds, 4, 70, M)[family]
        ex.run(spec, *args, strict=True)
    assert te.start_precompiler()
    try:
        for width in (1, 2, 8, 16):
            tspec, *targs = _requests(x, y, part.bounds, width, 71 + width,
                                      T)[family]
            jspec, *jargs = _requests(x, y, part.bounds, width, 71 + width,
                                      J)[family]
            assert te.precompile_async(tspec, *targs) is not None
            assert te.precompile_quiesce(120.0)
            before, n0 = sig_state(te), te.stats()["cache_size"]
            got = te.run(tspec, *targs)
            assert te.stats()["cache_size"] == n0, (family, width)
            assert sig_state(te) == before, (family, width)
            assert te.warm_for(tspec, *targs)
            assert_same(got, je.run(jspec, *jargs), (family, width))
        assert te.stats()["async_compiles"] > 0
    finally:
        te.stop_precompiler()


# -- epochs and the life cycle -----------------------------------------------

def test_capacity_growth_clears_warm_widths(built):
    """An insert that grows the delta capacity bumps shape_epoch (as in
    the JAX scheduler) and clears the scheduler's warm widths and
    pending labels; the next batch is handed over afresh."""
    x, y, part = built[:3]
    js, ts = _sessions(built, delta_cap=8)
    _settle(js, ts, x, y, part.bounds)
    for s in (js, ts):
        s.executor.start_precompiler()
    jsched = js.scheduler(bench=BENCH, start=False)
    tsched = ts.scheduler(bench=BENCH, start=False)
    bx, by = ds.make("gaussian", 64, seed=77)
    try:
        for M, sched in ((J, jsched), (T, tsched)):
            spec, *args = _requests(x, y, part.bounds, 3, 78, M)["point"]
            sched.submit(spec, *args)
            _drain_held(sched)
        assert tsched._warm and tsched._warm_epoch == \
            ts.executor.index.shape_epoch
        se0 = ts.executor.index.shape_epoch
        for M, sched in ((J, jsched), (T, tsched)):
            sched.submit(M.InsertBatch(), bx, by)
            sched.drain()
        assert ts.executor.index.shape_epoch > se0
        assert (js.executor.index.shape_epoch
                == ts.executor.index.shape_epoch)
        tsched._check_epoch()
        assert tsched._warm == {} and tsched._pc_pending == {}
        jt, tt = [], []
        for M, sched, out in ((J, jsched, jt), (T, tsched, tt)):
            spec, *args = _requests(x, y, part.bounds, 3, 79, M)["point"]
            out.append(sched.submit(spec, *args))
            _drain_held(sched)
        assert list(jsched.events) == list(tsched.events)
        assert jsched.stats()["precompile_pending"] == \
            tsched.stats()["precompile_pending"]
        assert_same(jt[0].result(), tt[0].result())
    finally:
        for s in (jsched, tsched):
            s.close()
        for s in (js, ts):
            s.executor.stop_precompiler()


def test_stale_epoch_job_installs_nothing(built):
    """A job handed over at one shape epoch and run after a capacity
    growth bumped it installs no program."""
    x, y, part = built[:3]
    te = T.Executor(built[4], config=T.EngineConfig(backend="torch",
                                                    delta_cap=8), **CPU)
    spec, *args = _requests(x, y, part.bounds, 4, 81, T)["range_count"]
    te.run(spec, *args)
    assert te.start_precompiler()
    gate = threading.Event()
    try:
        te._pc_submit(("hold",),                 # the worker waits here
                      lambda: gate.wait() and 0)
        label = te.precompile_async(spec, *(a[:2] for a in args))
        assert label is not None
        bx, by = ds.make("gaussian", 64, seed=82)
        te.run(T.InsertBatch(), bx, by)          # grows the capacity
        assert label[-1] != te.index.shape_epoch
        keys0, compiles0 = te.cache_keys(), te.async_compiles
        gate.set()
        assert te.precompile_quiesce(60.0) and te.precompile_done(label)
        assert te.cache_keys() == keys0
        assert te.async_compiles == compiles0
    finally:
        gate.set()
        te.stop_precompiler()


def test_precompiler_life_cycle(built):
    """start is idempotent on both packages; a job that raises is
    swallowed and marked done (a capture failure counted), and stop
    joins the thread."""
    je = J.Executor(built[3], config=J.EngineConfig(backend="xla"))
    te = T.Executor(built[4], config=T.EngineConfig(backend="torch"),
                    **CPU)
    for ex in (je, te):
        assert not ex.precompiling
        assert ex.start_precompiler() is True
        assert ex.start_precompiler() is False
        assert ex.precompiling

    def boom():
        raise ValueError("a failing speculative job")

    def capture_fails():
        raise GraphCaptureError("a capture that raised")

    for ex in (je, te):
        assert ex._pc_submit(("boom",), boom) == ("boom",)
        assert ex._pc_submit(("boom",), boom) is None    # seen once
        assert ex.precompile_quiesce(60.0)
        assert ex.precompile_done(("boom",))
        assert ex._pc_thread.is_alive()
    te._pc_submit(("capture",), capture_fails)
    assert te.precompile_quiesce(60.0) and te.precompile_done(("capture",))
    assert te.stats()["async_capture_errors"] == 1
    assert te.stats()["async_compiles"] == 0
    for ex in (je, te):
        t = ex._pc_thread
        ex.stop_precompiler()
        assert not t.is_alive() and not ex.precompiling
        ex.stop_precompiler()                    # a no-op when stopped
    assert te.precompile_async(T.PointQuery(), np.zeros(1, np.float32),
                               np.zeros(1, np.float32)) is None


# -- row chunks at a warm width (the scheduler's on the card) ---------------

@pytest.mark.parametrize("family", ["point", "range_count", "range",
                                    "circle_mat", "knn", "knn_exact",
                                    "join", "join_full"])
def test_run_rows_is_one_call(built, family):
    """``Executor.run_rows`` (2-row slices of a 7-row batch, the last
    padded) answers bitwise as one call and as the JAX Executor, and an
    adaptive family's stashed ok flags cover every slice."""
    x, y, part, jidx, tidx = built
    je = J.Executor(jidx, config=J.EngineConfig(backend="xla"))
    te = T.Executor(tidx, config=T.EngineConfig(backend="torch"), **CPU)
    for ex, M in ((je, J), (te, T)):             # sticky tiers settle
        spec, *args = _requests(x, y, part.bounds, 4, 70, M)[family]
        ex.run(spec, *args, strict=True)
    tspec, *targs = _requests(x, y, part.bounds, 7, 91, T)[family]
    jspec, *jargs = _requests(x, y, part.bounds, 7, 91, J)[family]
    targs = [torch.as_tensor(a) for a in targs]
    got = te.run_rows(tspec, *targs, rows=2)
    base = tspec.sticky_key()
    if base in te._sticky:
        assert te._pending[base][1].shape[0] == 8    # 4 slices of 2
    assert_same(got, te.run(tspec, *targs), family)
    assert_same(got, je.run(jspec, *jargs), family)
