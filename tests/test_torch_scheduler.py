"""The port's streaming serve scheduler, bitwise against the JAX
package's on the CPU.

The same requests go through the JAX ``SpatialServeSession.scheduler``
(xla backend) and the port's (``backend="torch"``, ``device="cpu"``),
both given the same bench dict. In drain mode (``start=False``) every
ticket's result, ``epoch`` and ``batched`` are compared bitwise, and so
are the ``events`` log, every key of ``stats()`` and the executor
counters (``host_syncs``, ``probe_syncs``, ``dispatches``, ``sticky``,
``epoch``).

Ported from the reference's tests/test_scheduler.py and
tests/test_scheduler_ordering.py (their xla cases), plus the port's
own: eight concurrent submitters on the worker thread, a numpy request
and a tensor request coalescing, backpressure at ``serve_queue_depth``,
``close()`` flushing the queue, a failing batch failing only its own
tickets, and the ``request_maintain()`` barrier.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro import core as J
from repro.serve import SpatialServeSession as JSession
from repro.serve import micro_batch_caps as j_caps
from repro.serve.scheduler import bench_spec_name as j_name
from repro_torch import core as T
from repro_torch.data import spatial as ds
from repro_torch.serve import SpatialServeSession as TSession
from repro_torch.serve import micro_batch_caps as t_caps
from repro_torch.serve.scheduler import bench_spec_name as t_name

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

N = 2500
SPEC_NAMES = ("point", "range_count", "range", "circle", "circle_mat",
              "knn5", "join")
# one inline bench record for both packages: every spec of
# _warm_requests measured wide, so each coalesces to serve_max_batch
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


def assert_same_state(js, ts, what=""):
    """Events, every stats() key and the executor counters."""
    assert list(js.events) == list(ts.events), what
    assert js.stats() == ts.stats(), what
    je, te = js.ex, ts.ex
    assert je.host_syncs == te.host_syncs, what
    assert je.probe_syncs == te.probe_syncs, what
    assert je.dispatches == te.dispatches, what
    assert je._sticky == te._sticky, what
    assert je.epoch == te.epoch, what


def assert_tickets(jts, tts, what=""):
    assert len(jts) == len(tts)
    for i, (a, b) in enumerate(zip(jts, tts)):
        assert a.done() and b.done(), (what, i)
        assert (a.epoch, a.batched) == (b.epoch, b.batched), (what, i)
        assert_same(a.result(), b.result(), f"{what} request {i}")


def specs_of(req, M):
    """A request (spec name, kwargs, *args) as ``M``'s (spec, *args)."""
    name, kw, *args = req
    return (getattr(M, name)(**kw), *args)


class Pair:
    """A JAX scheduler and a port scheduler driven in lockstep."""

    def __init__(self, jsess, tsess, **kw):
        self.j = jsess.scheduler(**kw)
        self.t = tsess.scheduler(**kw)
        self.jt, self.tt = [], []

    def submit(self, req):
        self.jt.append(self.j.submit(*specs_of(req, J)))
        self.tt.append(self.t.submit(*specs_of(req, T)))
        return self.tt[-1]

    def drain(self, what=""):
        self.j.drain()
        self.t.drain()
        assert_tickets(self.jt, self.tt, what)
        assert_same_state(self.j, self.t, what)

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(scope="module")
def built():
    x, y = ds.make("gaussian", N, seed=3)
    part = J.fit("kdtree", x, y, 6, seed=0)
    return (x, y, part, J.build_index(x, y, part),
            T.build_index(x, y, T.fit("kdtree", x, y, 6, seed=0),
                          device="cpu"))


def _warm_requests(x, y, part, qn=6, seed=0):
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), qn)
    rects = ds.random_rects(qn, 1e-3, part.bounds, seed=seed + 1,
                            centers=(x, y))
    polys, ne = ds.random_polygons(4, part.bounds, seed=seed + 2)
    r = np.full(qn, 0.03, np.float32)
    return [("PointQuery", {}, x[ix], y[ix]),
            ("RangeCount", {}, rects),
            ("RangeQuery", {}, rects),
            ("CircleQuery", {}, x[ix], y[ix], r),
            ("CircleQuery", {"materialize": True}, x[ix], y[ix], r),
            ("Knn", {"k": 5}, x[ix], y[ix]),
            ("SpatialJoin", {}, polys, ne)]


@pytest.fixture(scope="module")
def sess(built):
    """Warmed sessions of both packages (sticky tiers settled)."""
    x, y, part, jidx, tidx = built
    js = JSession(jidx, config=J.EngineConfig(backend="xla"))
    ts = TSession(tidx, config=T.EngineConfig(backend="torch"),
                  device="cpu")
    warm = _warm_requests(x, y, part)
    js.warmup([specs_of(r, J) for r in warm])
    ts.warmup([specs_of(r, T) for r in warm])
    return x, y, part, js, ts


def _serial(js, ts, reqs):
    """Each request through both sessions' submit, held equal; the
    port's results."""
    out = []
    for i, req in enumerate(reqs):
        jo = js.submit(*specs_of(req, J))
        to = ts.submit(*specs_of(req, T))
        assert_same(jo, to, f"serial request {i}")
        out.append(to)
    return out


def _mixed_singles(x, y, part, n, seed):
    """n single-query requests over 4 spec kinds, all distinct."""
    rng = np.random.default_rng(seed)
    rects = ds.random_rects(n, 1e-3, part.bounds, seed=seed + 1,
                            centers=(x, y))
    reqs = []
    for i in range(n):
        j = int(rng.integers(0, len(x)))
        kind = i % 4
        if kind == 0:
            reqs.append(("PointQuery", {}, x[j:j + 1], y[j:j + 1]))
        elif kind == 1:
            reqs.append(("RangeCount", {}, rects[i:i + 1]))
        elif kind == 2:
            reqs.append(("Knn", {"k": 5}, x[j:j + 1], y[j:j + 1]))
        else:
            reqs.append(("CircleQuery", {}, x[j:j + 1], y[j:j + 1],
                         np.full(1, 0.03, np.float32)))
    return reqs


# -- tests/test_scheduler.py ----------------------------------------------

def test_coalesce_routes_and_matches_serial(sess):
    x, y, part, js, ts = sess
    reqs = _mixed_singles(x, y, part, 24, seed=11)
    serial = _serial(js, ts, reqs)
    p = Pair(js, ts, bench=BENCH, start=False)
    for req in reqs:
        p.submit(req)
    assert not any(t.done() for t in p.tt)       # nothing ran yet
    p.drain("coalesced")
    st = p.t.stats()
    # 24 single-query requests formed one batch per spec kind
    assert st["read_batches"] == 4
    assert st["max_batch"] > 1 and st["mean_batch"] > 1
    for i, (t, ref) in enumerate(zip(p.tt, serial)):
        assert t.batched > 1
        assert_same(t.result(), ref, f"request {i}")
    assert st["maintain_busy"] == 0
    p.close()


def test_bitwise_matches_serial_every_spec(sess):
    """Every spec x request widths 1..3, coalesced vs serial bitwise
    (the materializing range and circle windows and the join too)."""
    x, y, part, js, ts = sess
    rng = np.random.default_rng(23)
    rects = ds.random_rects(9, 1e-3, part.bounds, seed=24, centers=(x, y))
    polys, ne = ds.random_polygons(6, part.bounds, seed=25)
    reqs = []
    for lo, hi in ((0, 1), (1, 3), (3, 6)):      # widths 1, 2, 3
        ix = rng.integers(0, len(x), hi - lo)
        qx, qy = x[ix], y[ix]
        r = np.full(hi - lo, 0.03, np.float32)
        reqs += [("PointQuery", {}, qx, qy),
                 ("RangeCount", {}, rects[lo:hi]),
                 ("RangeQuery", {}, rects[lo:hi]),
                 ("CircleQuery", {}, qx, qy, r),
                 ("CircleQuery", {"materialize": True}, qx, qy, r),
                 ("Knn", {"k": 5}, qx, qy),
                 ("SpatialJoin", {}, polys[lo:hi], ne[lo:hi])]
    serial = _serial(js, ts, reqs)
    p = Pair(js, ts, bench=BENCH, start=False)
    for req in reqs:
        p.submit(req)
    p.drain("every spec")
    st = p.t.stats()
    assert st["read_batches"] == 7               # one batch per spec
    assert st["max_batch"] == 6                  # 1+2+3 coalesced
    batches = [e for e in p.t.events if e[0] == "batch"]
    assert [e[3] for e in batches] == [8] * 7    # padded to 8 rows
    for i, (t, ref) in enumerate(zip(p.tt, serial)):
        assert t.batched == 6
        assert_same(t.result(), ref, f"request {i} ({reqs[i][0]})")
    p.close()


@pytest.mark.parametrize("case", ["both_columns", "per_backend",
                                  "no_specs", "not_a_dict"])
def test_micro_batch_caps_from_bench_columns(case, tmp_path):
    bench = {
        "both_columns": {
            "bench_q": 16, "bench_q_wide": 256,
            "specs": {"point": {"steady_us_per_q": 100.0,
                                "steady_us_per_q_b256": 10.0},
                      "knn10": {"steady_us_per_q": 100.0,
                                "steady_us_per_q_b256": 900.0},
                      "join": {"steady_us_per_q": 100.0},
                      "circle": {"steady_us_per_q_b256": 3.0}}},
        "per_backend": {
            "bench_q_wide": 64,
            "backends": {b: {"specs": {"range": {
                "steady_us_per_q": 1.0, "steady_us_per_q_b256": 1.0}}}
                for b in ("xla", "torch")}},
        "no_specs": {"bench_q_wide": 128},
        "not_a_dict": [1, 2],
    }[case]
    want = {"both_columns": {"point": 256, "knn10": 256},
            "per_backend": {"range": 64}, "no_specs": {},
            "not_a_dict": {}}[case]
    jc, tc = J.EngineConfig(), T.EngineConfig()
    assert t_caps(bench, "torch", tc) == j_caps(bench, "xla", jc) == want
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    assert t_caps(str(path), "torch", tc) == want
    assert t_caps("/nonexistent/path.json", "torch", tc) == {}
    assert t_caps(None, "torch", tc) == {}
    for name, kw in (("PointQuery", {}), ("RangeCount", {}),
                     ("RangeQuery", {}), ("CircleQuery", {}),
                     ("CircleQuery", {"materialize": True}),
                     ("Knn", {"k": 10}), ("SpatialJoin", {}),
                     ("InsertBatch", {}), ("DeleteBatch", {})):
        assert (t_name(getattr(T, name)(**kw)) ==
                j_name(getattr(J, name)(**kw)))


def test_scheduler_honors_per_spec_cap(sess):
    x, y, part, js, ts = sess
    bench = {"bench_q": 4, "bench_q_wide": 4,
             "specs": {"knn5": {"steady_us_per_q": 1.0,
                                "steady_us_per_q_b256": 0.9}}}
    p = Pair(js, ts, bench=bench, start=False)
    assert p.t.caps["knn5"] == 4
    rng = np.random.default_rng(31)
    for j in rng.integers(0, len(x), 10):
        p.submit(("Knn", {"k": 5}, x[j:j + 1], y[j:j + 1]))
    p.drain("cap 4")
    # 10 single-query kNN requests under a cap of 4 -> 4, 4, 2
    widths = [e[2] for e in p.t.events if e[0] == "batch"]
    assert len(widths) == 3 and max(widths) == 4
    p.close()


def test_no_bench_coalesces_to_serve_max_batch(sess):
    """bench=None reads no file: no caps, every spec's cap is
    serve_max_batch."""
    x, y, part, js, ts = sess
    sched = ts.scheduler(start=False)
    assert sched.caps == {}
    assert sched._cap(T.Knn(k=5)) == sched.cfg.serve_max_batch == 256
    sched.close()


def _worker_round(js, ts, reqs, serial, n_clients):
    """reqs through the port's worker thread from ``n_clients``
    concurrent submitters; every ticket bitwise its serial result."""
    with ts.scheduler(bench=BENCH, start=True) as sched:
        tickets = [None] * len(reqs)

        def client(k):
            for i in range(k, len(reqs), n_clients):
                tickets[i] = sched.submit(*specs_of(reqs[i], T))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        for i, t in enumerate(tickets):
            assert_same(t.result(timeout=60.0), serial[i], f"request {i}")
        st = sched.stats()
        assert st["reads"] == len(reqs)
        assert st["maintain_busy"] == 0
    with pytest.raises(RuntimeError):             # closed
        sched.submit(T.PointQuery(), reqs[0][2], reqs[0][3])


def test_worker_thread_concurrent_submitters(sess):
    """The reference's worker case (4 submitters, 32 requests) on both
    packages: each bitwise its serial results, which agree."""
    x, y, part, js, ts = sess
    reqs = _mixed_singles(x, y, part, 32, seed=41)
    serial = _serial(js, ts, reqs)
    with js.scheduler(bench=BENCH, start=True) as jsched:
        jt = [jsched.submit(*specs_of(r, J)) for r in reqs]
        for i, t in enumerate(jt):
            assert_same(t.result(timeout=60.0), serial[i], f"jax {i}")
    _worker_round(js, ts, reqs, serial, 4)


def test_worker_thread_eight_submitters(sess):
    x, y, part, js, ts = sess
    reqs = _mixed_singles(x, y, part, 64, seed=43)
    serial = [ts.submit(*specs_of(r, T)) for r in reqs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _worker_round(js, ts, reqs, serial, 8)
    finally:
        sys.setswitchinterval(old)


def test_submit_validates_like_executor(sess):
    x, y, part, js, ts = sess
    for M, s in ((J, js), (T, ts)):
        sched = s.scheduler(bench=BENCH, start=False)
        with pytest.raises(TypeError):
            sched.submit("point", x[:1], y[:1])
        with pytest.raises(TypeError):
            sched.submit(M.PointQuery(), x[:1])   # wrong arity
        with pytest.raises(TypeError):
            s.executor.run(M.PointQuery(), x[:1])
        sched.close()


# -- the port's own ---------------------------------------------------------

def test_numpy_and_tensor_requests_coalesce(sess):
    """A numpy float32 request and a torch.float32 request of one spec
    share one batch, bitwise the serial results."""
    x, y, part, js, ts = sess
    a = (x[10:12], y[10:12])
    b = (torch.as_tensor(x[20:23]), torch.as_tensor(y[20:23]))
    sched = ts.scheduler(bench=BENCH, start=False)
    ta = sched.submit(T.Knn(k=5), *a)
    tb = sched.submit(T.Knn(k=5), *b)
    sched.drain()
    assert list(sched.events)[0] == ("batch", "knn5", 5, 8, 2)
    assert ta.batched == tb.batched == 5
    assert_same(ta.result(), ts.submit(T.Knn(k=5), *a))
    assert_same(tb.result(), ts.submit(T.Knn(k=5), *b))
    sched.close()


def test_failing_batch_fails_only_its_tickets(sess):
    x, y, part, js, ts = sess
    sched = ts.scheduler(bench=BENCH, start=False)
    good = sched.submit(T.PointQuery(), x[:2], y[:2])
    bad = sched.submit(T.RangeCount(), np.zeros((1, 3), np.float32))
    sched.drain()
    assert bad.done()
    with pytest.raises(RuntimeError):           # the executor's error
        bad.result()
    assert_same(good.result(), ts.submit(T.PointQuery(), x[:2], y[:2]))
    assert sched.stats()["read_batches"] == 1
    sched.close()


def _wait_until(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


def test_backpressure_at_queue_depth(built):
    """With serve_queue_depth 4 and the worker held inside a dispatch,
    a submitter blocks once four requests are queued, and goes on when
    the worker drains them."""
    x, y, part, _, tidx = built
    ts = TSession(tidx, config=T.EngineConfig(backend="torch",
                                              serve_queue_depth=4),
                  device="cpu")
    reqs = [(T.PointQuery(), x[i:i + 1], y[i:i + 1]) for i in range(9)]
    serial = [ts.submit(*r) for r in reqs]
    ex = ts.executor
    with ts.scheduler(start=True) as sched:
        tickets = []
        with ex._lock:                           # the worker waits here
            tickets.append(sched.submit(*reqs[0]))
            _wait_until(lambda: sched.stats()["inflight"] == 1,
                        "the worker took the first request")
            th = threading.Thread(target=lambda: tickets.extend(
                sched.submit(*r) for r in reqs[1:]))
            th.start()
            _wait_until(lambda: sched.stats()["queue_len"] == 4,
                        "four requests queued")
            time.sleep(0.05)
            st = sched.stats()
            assert st["queue_len"] == 4 and st["submitted"] == 5
            assert th.is_alive()                 # blocked in submit
        th.join(timeout=60.0)
        assert not th.is_alive()
        for t, ref in zip(tickets, serial):
            assert_same(t.result(timeout=60.0), ref)
        assert sched.stats()["submitted"] == 9


@pytest.mark.parametrize("start", [False, True])
def test_close_flushes_the_queue(sess, start):
    x, y, part, js, ts = sess
    sched = ts.scheduler(bench=BENCH, start=start)
    tickets = [sched.submit(T.PointQuery(), x[i:i + 1], y[i:i + 1])
               for i in range(5)]
    sched.close()
    assert all(t.done() for t in tickets)
    for i, t in enumerate(tickets):
        assert_same(t.result(),
                    ts.submit(T.PointQuery(), x[i:i + 1], y[i:i + 1]))
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(T.PointQuery(), x[:1], y[:1])
    with pytest.raises(RuntimeError, match="closed"):
        sched.request_maintain()


# -- tests/test_scheduler_ordering.py ---------------------------------------

M_N = 1500


@pytest.fixture(scope="module")
def ordering_data():
    x, y = ds.make("gaussian", M_N, seed=5)
    jpart = J.fit("kdtree", x, y, 4, seed=0)
    tpart = T.fit("kdtree", x, y, 4, seed=0)
    return x, y, jpart, tpart


def _ordering_pair(data, **cfg):
    x, y, jpart, tpart = data
    js = JSession(J.build_index(x, y, jpart),
                  config=J.EngineConfig(backend="xla", **cfg))
    ts = TSession(T.build_index(x, y, tpart, device="cpu"),
                  config=T.EngineConfig(backend="torch", **cfg),
                  device="cpu")
    return js, ts, Pair(js, ts, bench=BENCH, start=False)


def _pt(v):
    return np.asarray([v], np.float32)


def test_read_after_insert_observes_epoch(ordering_data):
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32)
    nx, ny = _pt(0.123456), _pt(0.654321)      # not in the dataset
    t_pre = p.submit(("PointQuery", {}, nx, ny))
    t_w = p.submit(("InsertBatch", {}, nx, ny))
    t_post = p.submit(("PointQuery", {}, nx, ny))
    p.drain("read after insert")
    assert not bool(t_pre.result()[0])
    assert t_pre.epoch < t_w.epoch
    assert t_w.epoch == 1 and t_post.epoch >= t_w.epoch
    assert bool(t_post.result()[0])
    assert p.t.stats()["maintain_busy"] == 0
    p.close()


def test_read_after_delete_observes_epoch(ordering_data):
    x, y = ordering_data[:2]
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32)
    qx, qy = _pt(x[7]), _pt(y[7])               # a resident point
    t0 = p.submit(("PointQuery", {}, qx, qy))
    t_w = p.submit(("DeleteBatch", {}, qx, qy))
    t1 = p.submit(("PointQuery", {}, qx, qy))
    p.drain("read after delete")
    assert bool(t0.result()[0]) and not bool(t1.result()[0])
    assert int(t_w.result()) >= 1
    assert t0.epoch < t_w.epoch <= t1.epoch
    p.close()


def test_consecutive_inserts_merge_and_route_vids(ordering_data):
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32)
    ax = np.asarray([0.111, 0.222, 0.333], np.float32)
    ay = np.asarray([0.444, 0.555, 0.666], np.float32)
    bx = np.asarray([0.777, 0.888], np.float32)
    by = np.asarray([0.112, 0.223], np.float32)
    ta = p.submit(("InsertBatch", {}, ax, ay))
    tb = p.submit(("InsertBatch", {}, bx, by))
    t_read = p.submit(("PointQuery", {}, np.concatenate([ax, bx]),
                       np.concatenate([ay, by])))
    p.drain("merged inserts")      # vids equal the reference's, bitwise
    va, vb = np.asarray(ta.result()), np.asarray(tb.result())
    assert p.t.stats()["write_merges"] == 1
    assert va.shape == (3,) and vb.shape == (2,)
    assert len(set(va.tolist() + vb.tolist())) == 5
    assert ta.epoch == tb.epoch
    assert t_read.epoch >= ta.epoch
    assert bool(t_read.result().all())
    p.close()


def test_reads_never_hoisted_across_write(ordering_data):
    """Each read reflects exactly the writes enqueued before it: the
    count goes base -> base+1 -> base+2 as inserts land between."""
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32)
    rect = np.asarray([[0.21, 0.21, 0.29, 0.29]], np.float32)
    base = int(ts.submit(T.RangeCount(), rect)[0])
    assert base == int(np.asarray(js.submit(J.RangeCount(), rect))[0])
    t0 = p.submit(("RangeCount", {}, rect))
    p.submit(("InsertBatch", {}, _pt(0.25), _pt(0.25)))
    t1 = p.submit(("RangeCount", {}, rect))
    p.submit(("InsertBatch", {}, _pt(0.26), _pt(0.26)))
    t2 = p.submit(("RangeCount", {}, rect))
    p.drain("no hoisting")
    assert [int(t.result()[0]) for t in (t0, t1, t2)] == [
        base, base + 1, base + 2]
    assert t0.epoch < t1.epoch < t2.epoch
    p.close()


def test_barrier_across_occupancy_compaction(ordering_data):
    """An insert that trips the delta-occupancy threshold schedules a
    re-fit; drain()'s idle maintenance runs it with an EMPTY queue,
    after the queued write and read, and reads stay exact."""
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32,
                               delta_occupancy=0.0)
    nx = np.linspace(0.31, 0.39, 9).astype(np.float32)
    ny = np.linspace(0.61, 0.69, 9).astype(np.float32)
    t_w = p.submit(("InsertBatch", {}, nx, ny))
    t_r = p.submit(("PointQuery", {}, nx, ny))
    p.drain("occupancy re-fit")
    ex = ts.executor
    assert ex.refits == 1 and not ex.stats()["pending_refit"]
    maint = [e for e in p.t.events if e[0] == "maintain"]
    assert maint and all(e[1] == 0 for e in maint)
    kinds = [e[0] for e in p.t.events]
    assert kinds.index("maintain") > max(
        i for i, k in enumerate(kinds) if k in ("batch", "write"))
    assert bool(t_r.result().all()) and t_r.epoch >= t_w.epoch
    t2 = p.submit(("PointQuery", {}, nx, ny))
    p.drain("after the re-fit")
    assert bool(t2.result().all())
    assert t2.epoch > t_r.epoch                 # the re-fit bumped it
    assert p.t.stats()["maintain_busy"] == 0
    p.close()


def test_request_maintain_is_a_barrier(ordering_data):
    """An explicit maintenance barrier runs after what was queued before
    it and before what comes after, resolving with maintain()'s dict."""
    js, ts, p = _ordering_pair(ordering_data, delta_cap=32,
                               delta_occupancy=0.0)
    nx, ny = _pt(0.35), _pt(0.65)
    t_w = p.submit(("InsertBatch", {}, nx, ny))
    jm, tm = p.j.request_maintain(), p.t.request_maintain()
    t_r = p.submit(("PointQuery", {}, nx, ny))
    p.j.drain()
    p.t.drain()
    assert jm.result() == tm.result() and tm.result()["refit"]
    assert (jm.epoch, jm.batched) == (tm.epoch, tm.batched)
    assert tm.epoch > t_w.epoch and t_r.epoch == tm.epoch
    assert_same_state(p.j, p.t, "request_maintain")
    assert [e[0] for e in p.t.events] == ["write", "maintain", "batch"]
    assert bool(t_r.result()[0])
    p.close()
