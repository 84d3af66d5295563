"""Serving mode of the port, bitwise against the JAX package on the CPU.

The same sequences of calls go through the JAX ``Executor`` /
``SpatialServeSession`` (xla backend) and the port's (``device="cpu"``).
After every step the outputs are compared bitwise, and so are
``host_syncs``, ``dispatches``, the sticky tiers, the rest of the
serving state (``_initial``, ``_ok_streak``, ``_demoted_from``,
``_demote_backoff``, the tiers of the stashed ok flags) and the dict
that ``maintain()`` returns.

Ported from the reference's tests/test_plan.py (zero-sync steady state,
the fused fallback on overflow, maintain() escalation, facade and plan
API sharing one tier, equal specs sharing one cached program, eviction
of superseded cap variants; after every step the program-cache keys
equal the JAX Executor's) and tests/test_compaction.py (demotion and its
back-off), plus the pruned kNN's fixed-round serving form and a mixed
serving round at q = 16 and at q = 64 (bucketed, and tier_buckets off).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import range_oracle
from repro import core as J
from repro.core import local_ops as JL
from repro.serve import SpatialServeSession as JSession
from repro_torch import core as T
from repro_torch.core import local_ops as TL
from repro_torch.data import spatial as ds
from repro_torch.serve import SpatialServeSession as TSession

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))

STATE = ("_initial", "_ok_streak", "_demoted_from", "_demote_backoff")


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


def assert_same(j_out, t_out, what=""):
    """Bitwise equality of a JAX result and a port result."""
    j_out, t_out = _leaves(j_out), _leaves(t_out)
    assert len(j_out) == len(t_out), what
    for a, b in zip(j_out, t_out):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what


def cache_keys(ex) -> set:
    """An executor's program-cache keys, the JAX backend names mapped to
    the port's (xla -> torch, pallas -> cuda)."""
    names = {"xla": "torch", "pallas": "cuda"}
    return {(names.get(k[0], k[0]),) + k[1:] for k in ex.cache_keys()}


def specs(name, **kw):
    """The (JAX, port) QuerySpec pair of one spec class."""
    return getattr(J, name)(**kw), getattr(T, name)(**kw)


class Pair:
    """One JAX executor and one port executor driven in lockstep."""

    def __init__(self, jex, tex):
        self.j, self.t = jex, tex

    def check_state(self, what=""):
        j, t = self.j, self.t
        assert j.host_syncs == t.host_syncs, what
        assert j.probe_syncs == t.probe_syncs, what
        assert j.dispatches == t.dispatches, what
        assert j._sticky == t._sticky, what
        for name in STATE:
            assert getattr(j, name) == getattr(t, name), (name, what)
        assert ({b: v[0] for b, v in j._pending.items()} ==
                {b: v[0] for b, v in t._pending.items()}), what
        # the program caches hold the same keys (eviction included)
        assert cache_keys(j) == cache_keys(t), what
        assert j.stats()["cache_size"] == t.stats()["cache_size"], what

    def run(self, name, *args, strict=False, **kw):
        js, ts = specs(name, **kw)
        jo = self.j.run(js, *args, strict=strict)
        to = self.t.run(ts, *args, strict=strict)
        assert_same(jo, to, name)
        self.check_state(name)
        return to

    def maintain(self):
        jm, tm = self.j.maintain(), self.t.maintain()
        assert jm == tm
        self.check_state("maintain")
        return tm


@pytest.fixture(scope="module")
def gauss(built_index):
    """conftest's JAX index (gaussian 12k points, kdtree 12) and the
    port's build of the same points: the golden fixture's index."""
    x, y, part, jidx = built_index
    tidx = T.build_index(x, y, T.fit("kdtree", x, y, 12, seed=0),
                         device="cpu")
    return x, y, part, jidx, tidx


def pair(gauss, **cfg):
    _, _, _, jidx, tidx = gauss
    return Pair(J.Executor(jidx, config=J.EngineConfig(**cfg)),
                T.Executor(tidx, config=T.EngineConfig(**cfg),
                           device="cpu"))


# -- zero-host-sync steady state (tests/test_plan.py) ---------------------

def test_sticky_hit_runs_without_host_sync(gauss):
    x, y, part, _, _ = gauss
    p = pair(gauss)
    rects = ds.random_rects(8, 1e-4, part.bounds, seed=2, centers=(x, y))
    qx, qy = x[:8], y[:8]
    polys, ne = ds.random_polygons(6, part.bounds, seed=3)
    r = np.full(8, 0.03, np.float32)
    warm = [("RangeQuery", {}, (rects,)), ("Knn", {"k": 5}, (qx, qy)),
            ("SpatialJoin", {}, (polys, ne)),
            ("CircleQuery", {}, (qx, qy, r)),
            ("CircleQuery", {"materialize": True}, (qx, qy, r))]
    for name, kw, args in warm:              # cold: the strict loop
        p.run(name, *args, **kw)
    assert p.t.host_syncs > 0
    syncs = p.t.host_syncs
    out = [p.run(name, *args, **kw) for name, kw, args in warm]  # steady
    assert p.t.host_syncs == syncs
    p.run("PointQuery", qx, qy)              # exact specs never sync
    p.run("RangeCount", rects)
    assert p.t.host_syncs == syncs
    cnt, _, ok = out[0]                      # and the results are exact
    assert bool(ok.all())
    assert (cnt.numpy() == range_oracle(x, y, rects)).all()
    d2 = np.sort(out[1][0].numpy(), axis=1)
    want = np.sort((x[None, :] - qx[:, None]) ** 2 +
                   (y[None, :] - qy[:, None]) ** 2, axis=1)[:, :5]
    assert np.allclose(d2, want, rtol=1e-5, atol=1e-10)


def test_equal_specs_share_one_executable(gauss):
    x, y, part, _, _ = gauss
    p = pair(gauss)
    rects = ds.random_rects(8, 1e-4, part.bounds, seed=1, centers=(x, y))
    n0 = p.t.stats()["cache_size"]
    p.run("RangeQuery", rects, strict=True)
    n1 = p.t.stats()["cache_size"]
    assert n1 > n0                      # the first run caches a program
    # a DIFFERENT but equal spec instance hits the same cached program
    p.run("RangeQuery", rects, strict=True, cap=None)
    p.run("RangeQuery", rects, strict=True)
    assert p.t.stats()["cache_size"] == n1


def test_cache_evicts_superseded_cap_variants(gauss):
    """Escalation must not leak one cached program per tier: after the
    sticky tier settles, at most the sticky and initial tiers remain."""
    x, y, part, _, _ = gauss
    p = pair(gauss, range_cap=2, range_cand=1)
    base = T.RangeQuery().sticky_key()
    for sel in (1e-6, 1e-4, 1e-3, 1e-2, 1e-1):   # repeated escalation
        rects = ds.random_rects(6, sel, part.bounds, seed=int(sel * 1e7),
                                centers=(x, y))
        cnt, _, ok = p.run("RangeQuery", rects, strict=True)
        assert bool(ok.all())
        assert (cnt.numpy() == range_oracle(x, y, rects)).all()
        tiers = {v for _, v in p.t.cache_variants(base)}
        assert len(tiers) <= 2, tiers            # sticky + initial only
        assert p.t.cache_variants(base) == p.j.cache_variants(base)
    assert p.t._sticky[base] != (2, 1)           # escalation did happen


def test_fused_fallback_stays_exact_on_overflow(gauss):
    """A sticky tier too small for the batch: some rows overflow, some
    do not; the on-device fallback keeps every count exact."""
    x, y, part, _, _ = gauss
    p = pair(gauss, range_cap=2, range_cand=2)
    easy = ds.random_rects(8, 1e-6, part.bounds, seed=4, centers=(x, y))
    hard = ds.random_rects(8, 5e-2, part.bounds, seed=5, centers=(x, y))
    p.run("RangeQuery", easy, strict=True)     # sticky at a small tier
    syncs = p.t.host_syncs
    mixed = np.concatenate([easy[:4], hard[:4]])
    for rects in (hard, mixed):
        cnt, _, ok = p.run("RangeQuery", rects)   # overflows the window
        assert p.t.host_syncs == syncs            # still no host sync
        assert (cnt.numpy() == range_oracle(x, y, rects)).all()
        assert not bool(ok.all())                 # materialization flagged
    assert ok[:4].all()                           # the easy rows are ok


@pytest.mark.parametrize("fam", ["circle", "circle_mat", "knn", "join"])
def test_fused_fallback_per_family(gauss, fam):
    """Each family's fused program at a deliberately tiny sticky tier,
    on a batch in which some rows overflow and some do not: kNN's
    per-row merge, the circle and join counts from the exact programs."""
    x, y, part, _, _ = gauss
    p = pair(gauss, circle_cap=2, circle_cand=2, knn_cap=16, join_cap=2,
             join_cand=2)
    rng = np.random.default_rng(31)
    ix = rng.integers(0, len(x), 12)
    qx, qy = x[ix].copy(), y[ix].copy()
    qx[6:] = rng.random(6).astype(np.float32)      # sparse rows
    qy[6:] = rng.random(6).astype(np.float32)
    r = np.where(np.arange(12) < 6, 0.03, 1e-5).astype(np.float32)
    polys, ne = ds.random_polygons(6, part.bounds, seed=32, radius=0.004)
    big, bne = ds.random_polygons(2, part.bounds, seed=33, radius=0.2)
    polys = np.concatenate([polys, big[:, :polys.shape[1]]])
    ne = np.concatenate([ne, np.minimum(bne, polys.shape[1])]).astype(
        np.int32)
    name, kw, args = {
        "circle": ("CircleQuery", {}, (qx, qy, r)),
        "circle_mat": ("CircleQuery", {"materialize": True}, (qx, qy, r)),
        "knn": ("Knn", {"k": 4}, (qx, qy)),
        "join": ("SpatialJoin", {}, (polys, ne))}[fam]
    jspec, tspec = specs(name, **kw)
    tier = {"circle": (2, 2), "circle_mat": (2, 2), "knn": (16, 8),
            "join": (2, 2)}[fam]
    p.j._sticky[jspec.sticky_key()] = tier
    p.t._sticky[tspec.sticky_key()] = tier
    p.run(name, *args, **kw)
    ok = p.t._pending[tspec.sticky_key()][1]
    assert 0 < int(ok.sum()) < ok.shape[0]     # some rows overflowed
    assert p.t.host_syncs == 0
    p.maintain()                                # escalates the tier
    assert p.t._sticky[tspec.sticky_key()] != tier
    p.run(name, *args, **kw)


def test_maintain_escalates_overflowed_sticky_tier(gauss):
    x, y, part, _, _ = gauss
    p = pair(gauss, range_cap=2, range_cand=2)
    easy = ds.random_rects(8, 1e-6, part.bounds, seed=6, centers=(x, y))
    hard = ds.random_rects(8, 1e-2, part.bounds, seed=7, centers=(x, y))
    base = T.RangeQuery().sticky_key()
    p.run("RangeQuery", easy, strict=True)       # small sticky tier
    tier0 = p.t._sticky[base]
    _, _, ok = p.run("RangeQuery", hard)         # zero-sync, overflows
    assert not bool(ok.all())
    while p.maintain():                          # escalate until settled
        cnt, vids, ok = p.run("RangeQuery", hard)
    assert p.t._sticky[base] != tier0
    assert bool(ok.all())                        # window now complete
    assert (cnt.numpy() == range_oracle(x, y, hard)).all()
    p.run("RangeQuery", hard)                    # clean: stashes ok
    assert p.maintain() == {}


def test_facade_and_run_share_sticky_state(gauss):
    x, y, part, jidx, tidx = gauss
    jeng, teng = J.SpatialEngine(jidx), T.SpatialEngine(tidx, device="cpu")
    rects = ds.random_rects(6, 1e-4, part.bounds, seed=9, centers=(x, y))
    assert_same(jeng.range_query(rects), teng.range_query(rects))
    syncs = teng.executor.host_syncs
    assert jeng.executor.host_syncs == syncs
    jo = jeng.run_batch([(J.RangeQuery(), rects)])[0]
    to = teng.run_batch([(T.RangeQuery(), rects)])[0]   # fused path
    assert_same(jo, to)
    assert teng.executor.host_syncs == syncs
    assert (to[0].numpy() == range_oracle(x, y, rects)).all()


# -- demotion and back-off (tests/test_compaction.py) ---------------------

@pytest.fixture(scope="module")
def golden_q():
    from gen_golden import build_inputs
    return build_inputs()[3]


def _settle_peak(p, easy, rects, base):
    p.run("RangeQuery", easy, strict=True)
    assert p.t._sticky[base] == (2, 2)
    p.run("RangeQuery", rects)                  # overflows the tier
    while p.maintain():                         # escalate until clean
        p.run("RangeQuery", rects)
    return p.t._sticky[base]


def test_maintain_demotes_clean_sticky_tiers(gauss, golden_q):
    x, y, _, _, _ = gauss
    p = pair(gauss, range_cap=2, range_cand=2, demote_after=2)
    base = T.RangeQuery().sticky_key()
    easy = ds.random_rects(8, 1e-8, (0, 0, 1, 1), seed=5, centers=(x, y))
    peak = _settle_peak(p, easy, golden_q["rects"], base)
    assert peak != (2, 2)
    moved = {}
    for _ in range(10):                         # easy traffic again
        p.run("RangeQuery", easy)
        moved = p.maintain()
        if moved:
            break
    assert moved == {base: p.t._sticky[base]}
    assert p.t._sticky[base] < peak
    cnt, _, _ = p.run("RangeQuery", golden_q["rects"])   # still exact
    assert (cnt.numpy() == range_oracle(x, y, golden_q["rects"])).all()


def test_demotion_ping_pong_backs_off(gauss, golden_q):
    x, y, _, _, _ = gauss
    cfg = dict(range_cap=2, range_cand=2, demote_after=2)
    p = pair(gauss, **cfg)
    base = T.RangeQuery().sticky_key()
    easy = ds.random_rects(8, 1e-8, (0, 0, 1, 1), seed=5, centers=(x, y))
    hard = golden_q["rects"]
    peak = _settle_peak(p, easy, hard, base)
    demoted = {}
    for _ in range(5):                          # easy traffic demotes
        p.run("RangeQuery", easy)
        demoted = p.maintain()
        if demoted:
            break
    assert demoted and p.t._sticky[base] < peak
    # the demotion retraces the ladder: re-escalating lands on the peak
    assert p.t._escalators[base](*p.t._sticky[base]) == peak
    p.run("RangeQuery", hard)                   # bounces straight back
    assert p.maintain() == {base: peak}
    assert p.t._demote_backoff[base] == 2
    for _ in range(2 * cfg["demote_after"] - 1):   # doubled streak
        p.run("RangeQuery", easy)
        assert p.maintain() == {}
        assert p.t._sticky[base] == peak
    p.run("RangeQuery", easy)
    assert p.maintain()                         # the back-off elapsed
    assert p.t._sticky[base] < peak


# -- the pruned kNN's serving form ----------------------------------------

@pytest.mark.parametrize("case", ["one_round", "few_rounds", "all_rounds"])
def test_knn_fixed_rounds_equal_early_exit(gauss, case):
    """``fixed_rounds=True`` runs all knn_max_rounds rounds with no host
    read, and is bitwise the early-exit loop (and the JAX program) on
    inputs where the early exit stops after one round, a few, and
    none."""
    x, y, _, jidx, tidx = gauss
    rng = np.random.default_rng(41)
    ix = rng.integers(0, len(x), 8)
    qx = np.concatenate([x[ix], rng.random(4).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(4).astype(np.float32)])
    r0, rounds = {"one_round": (1.0, 6), "few_rounds": (2e-4, 24),
                  "all_rounds": (1e-7, 4)}[case]
    r0 = np.full(12, r0, np.float32)
    cfg = dict(knn_max_rounds=rounds)
    k, cand, cap = 5, 8, 64
    jex = J.Executor(jidx, config=J.EngineConfig(**cfg))
    tex = T.Executor(tidx, config=T.EngineConfig(**cfg), device="cpu")
    jfn = JL._KnnPrunedLocal(jex.index, jex.cfg, jex.backend, k, jex.spec,
                             cand, cap)
    want = jax.jit(lambda *a: jfn(jex.parts, jex.bounds, *a, axis=None))(
        qx, qy, r0)
    got = {}
    for fixed in (False, True):
        prog = TL._KnnPrunedLocal(tex.index, tex.cfg, tex.backend, k, cand,
                                  cap, fixed_rounds=fixed)
        calls = []
        inner = prog._round
        prog._round = lambda *a: calls.append(1) or inner(*a)
        got[fixed] = prog(tex.parts, tex.bounds, *(torch.from_numpy(a)
                                                   for a in (qx, qy, r0)))
        assert_same(want, got[fixed], f"fixed_rounds={fixed}")
        n = len(calls)
        if fixed:
            assert n == rounds
        elif case == "one_round":
            assert n == 1
        elif case == "few_rounds":
            assert 1 < n < rounds
        else:
            assert n == rounds and not bool(got[fixed][2].all())


# -- mixed serving rounds (src/repro/launch/serve.py's traffic) -----------

@pytest.fixture(scope="module")
def taxi():
    x, y = ds.make("taxi", 20000, seed=0)
    jpart = J.fit("kdtree", x, y, 16, seed=0)
    return (x, y, jpart.bounds, J.build_index(x, y, jpart),
            T.build_index(x, y, T.fit("kdtree", x, y, 16, seed=0),
                          device="cpu"))


def mixed_round(x, y, bounds, q, seed, pkg):
    """serve.py's make_round: point, range count, range query at
    selectivity 1e-5, circle r = 0.02, 10-NN, and a join of
    max(q // 8, 4) polygons."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), q)
    rects = ds.random_rects(q, 1e-5, bounds, seed=seed, centers=(x, y))
    polys, ne = ds.random_polygons(max(q // 8, 4), bounds, seed=seed)
    return [(pkg.PointQuery(), x[ix], y[ix]), (pkg.RangeCount(), rects),
            (pkg.RangeQuery(), rects),
            (pkg.CircleQuery(), x[ix], y[ix], np.full(q, 0.02, np.float32)),
            (pkg.Knn(k=10), x[ix], y[ix]), (pkg.SpatialJoin(), polys, ne)]


@pytest.mark.parametrize("q,cfg", [(16, {}), (64, {"tier_buckets": False}),
                                   (64, {})],
                         ids=["q16_default", "q64_no_buckets",
                              "q64_bucketed"])
def test_mixed_serving_rounds(taxi, q, cfg):
    """Warm-up, then steady rounds with maintain() after each, as
    src/repro/launch/serve.py runs them: every output bitwise,
    host_syncs +0 on every steady round, and the same maintain()
    results and tiers. At q = 64 with tier_buckets on (the reference's
    default batch) the range query, circle and kNN calls are bucketed
    (the join's q // 8 = 8 polygons are not): probe_syncs grows by three
    per round, as the JAX session's."""
    x, y, bounds, jidx, tidx = taxi
    js = JSession(jidx, config=J.EngineConfig(**cfg))
    ts = TSession(tidx, config=T.EngineConfig(**cfg), device="cpu")
    p = Pair(js.executor, ts.executor)
    js.warmup(mixed_round(x, y, bounds, q, 0, J))
    ts.warmup(mixed_round(x, y, bounds, q, 0, T))
    p.check_state("warmup")
    assert set(ts.stats()["sticky"]) == {("range",), ("circle", False),
                                         ("knn", 10), ("join",)}
    for rnd in range(1, 4):
        syncs = ts.stats()["host_syncs"]
        probes = ts.stats()["probe_syncs"]
        jo = js.submit_batch(mixed_round(x, y, bounds, q, rnd, J))
        to = ts.submit_batch(mixed_round(x, y, bounds, q, rnd, T))
        for a, b in zip(jo, to):
            assert_same(a, b, f"round {rnd}")
        p.check_state(f"round {rnd}")
        assert ts.stats()["host_syncs"] == syncs
        bucketed = q >= 32 and cfg.get("tier_buckets", True)
        assert ts.stats()["probe_syncs"] == probes + (3 if bucketed else 0)
        assert js.stats()["probe_syncs"] == ts.stats()["probe_syncs"]
        assert js.maintain() == ts.maintain()
        p.check_state(f"maintain {rnd}")
    st = ts.stats()
    assert st["backend"] == "torch" and st["sticky"] == dict(p.j._sticky)


def test_wide_serving_batch_is_bucketed(taxi):
    """With tier_buckets on, a batch of >= tier_bucket_min queries on a
    sticky tier takes the bucketed dispatch: bitwise the JAX session's,
    host_syncs +0 and probe_syncs +1 on both; a narrower batch makes no
    probe, and a strict call still runs."""
    x, y, bounds, jidx, tidx = taxi
    rects = ds.random_rects(32, 1e-5, bounds, seed=3, centers=(x, y))
    js, ts = JSession(jidx), TSession(tidx, device="cpu")
    p = Pair(js.executor, ts.executor)
    js.warmup([(J.RangeQuery(), rects[:8])])
    ts.warmup([(T.RangeQuery(), rects[:8])])
    p.check_state("warmup")
    syncs, probes = ts.stats()["host_syncs"], ts.stats()["probe_syncs"]
    assert_same(js.submit(J.RangeQuery(), rects),
                ts.submit(T.RangeQuery(), rects), "wide")
    p.check_state("wide")
    assert ts.stats()["host_syncs"] == syncs
    assert ts.stats()["probe_syncs"] == probes + 1
    assert js.stats()["probe_syncs"] == ts.stats()["probe_syncs"]
    assert_same(js.submit(J.RangeQuery(), rects[:31]),
                ts.submit(T.RangeQuery(), rects[:31]), "narrow")
    assert ts.stats()["probe_syncs"] == probes + 1
    assert_same(js.submit(J.RangeQuery(), rects, strict=True),
                ts.submit(T.RangeQuery(), rects, strict=True), "strict")
    p.check_state("strict")


def test_steady_round_makes_no_host_read(taxi, monkeypatch):
    """The CPU's stand-in for the card's sync check: with its inputs
    already tensors, a steady serving round neither reads a tensor on
    the host nor builds one from host data (each raises here), while
    the strict loop does read."""
    x, y, bounds, _, tidx = taxi
    ts = TSession(tidx, device="cpu")
    ts.warmup(mixed_round(x, y, bounds, 16, 0, T))
    rnd = [(r[0],) + tuple(torch.from_numpy(np.ascontiguousarray(a))
                           for a in r[1:])
           for r in mixed_round(x, y, bounds, 16, 1, T)]
    syncs = ts.stats()["host_syncs"]

    def boom(*a, **k):
        raise AssertionError("a host read or a host-to-device copy")

    for name in ("__bool__", "item", "tolist", "numpy", "__int__",
                 "__float__", "cpu", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    for name in ("tensor", "as_tensor", "from_numpy", "nonzero"):
        monkeypatch.setattr(torch, name, boom)
    out = ts.submit_batch(rnd)
    assert len(out) == 6 and ts.stats()["host_syncs"] == syncs
    with pytest.raises(AssertionError, match="host read"):
        ts.submit_batch(rnd, strict=True)


def test_threads_share_one_executor(gauss):
    """The executor lock: eight threads serving steady range queries on
    one executor while another runs maintain(), with a short switch
    interval; no dispatch is lost and every answer is the serial one."""
    import threading

    x, y, part, _, tidx = gauss
    ex = T.Executor(tidx, device="cpu")
    rects = torch.from_numpy(ds.random_rects(8, 1e-4, part.bounds, seed=51,
                                             centers=(x, y)))
    want = ex.run(T.RangeQuery(), rects, strict=True)
    d0, n_threads, calls = ex.dispatches, 8, 5
    got, errors = [], []

    def serve():
        try:
            for _ in range(calls):
                got.append(ex.run(T.RangeQuery(), rects))
        except Exception as e:          # reported below
            errors.append(e)

    def tune():
        for _ in range(calls):
            ex.maintain()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve) for _ in range(n_threads)]
        threads.append(threading.Thread(target=tune))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert ex.dispatches - d0 == n_threads * calls
    assert len(got) == n_threads * calls
    for out in got:
        assert all(torch.equal(a, b) for a, b in zip(out, want))
