"""Port parity end to end: every SpatialEngine read query (point_query,
range_count, range_query, circle_count, circle_query, knn pruned and
exact, join_count windowed and full) on the CPU, bitwise against the
golden fixture and against the JAX SpatialEngine (xla backend), both on
the port's own build and on the JAX index carried over with
``convert.index_from_arrays``; and the executor's strict adaptive
policy (escalation, sticky tiers, the cap override) and serving mode
on a sticky tier (bitwise the JAX package's; a wide batch raises).

Every comparison is bitwise: counts, ids, squared distances and ok
flags."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (EngineConfig, Executor, Knn, PointQuery,
                              RangeCount, SpatialEngine, build_index, fit)
from repro_torch.core import build as TB
from repro_torch.core.plan import CircleQuery, RangeQuery, SpatialJoin
from repro_torch.core.plan import EngineConfig as TConfig
from repro_torch.data import spatial as ds

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "spatial_golden.json")


def golden_inputs():
    """tests/golden/gen_golden.py:build_inputs, rebuilt by the port."""
    x, y = ds.make("gaussian", 12000, seed=7)
    part = fit("kdtree", x, y, 12, seed=0)
    rng = np.random.default_rng(11)
    ix = rng.integers(0, len(x), 32)
    qx = np.concatenate([x[ix[:16]],
                         rng.random(16).astype(np.float32) * 2 - 0.5])
    qy = np.concatenate([y[ix[:16]],
                         rng.random(16).astype(np.float32) * 2 - 0.5])
    rects = ds.random_rects(16, 1e-4, part.bounds, seed=13, centers=(x, y))
    return x, y, part, qx, qy, rects


def golden_extra(x, y, part):
    """gen_golden.py's circles and polygons."""
    ix = np.random.default_rng(11).integers(0, len(x), 32)
    cx, cy = x[ix[16:28]], y[ix[16:28]]
    cr = np.full(12, 0.04, np.float32)
    polys, ne = ds.random_polygons(8, part.bounds, seed=17)
    return cx, cy, cr, polys, ne


def replay_golden(eng, qx, qy, rects, cx, cy, cr, polys, ne) -> dict:
    """Every golden key, in gen_golden.py's order on one engine (the
    strict loop starts from the sticky tiers of earlier calls)."""
    out = {"point": eng.point_query(qx, qy).tolist(),
           "range_count": eng.range_count(rects).tolist()}
    cnt, vids, ok = eng.range_query(rects)
    out.update(range_query_cnt=cnt.tolist(), range_query_vids=vids.tolist(),
               range_query_ok=ok.tolist())
    out["circle_count"] = eng.circle_count(cx, cy, cr).tolist()
    d2, vid = eng.knn(qx, qy, 5, mode="pruned")
    out.update(knn_d2=d2.tolist(), knn_vid=vid.tolist())
    d2, vid = eng.knn(qx[:8], qy[:8], 3, mode="exact")
    assert d2.dtype == torch.float32 and vid.dtype == torch.int32
    out.update(knn_exact_d2=d2.tolist(), knn_exact_vid=vid.tolist())
    out["join_count"] = eng.join_count(polys, ne).tolist()
    return out


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden_index():
    x, y, part, qx, qy, rects = golden_inputs()
    return build_index(x, y, part, device="cpu"), qx, qy, rects


@pytest.mark.parametrize("chunk", [1, 5, 8, 16])
def test_golden_replay(golden_index, golden, chunk):
    idx, qx, qy, rects = golden_index
    eng = SpatialEngine(idx, EngineConfig(part_chunk=chunk), device="cpu")
    assert eng.backend == "torch" and eng.device == torch.device("cpu")
    assert eng.index.num_partitions % chunk == 0      # padded to chunks
    assert torch.equal(eng.run(PointQuery(), qx, qy),
                       eng.point_query(qx, qy))
    x, y, part = golden_inputs()[:3]
    extra = golden_extra(x, y, part)
    got = replay_golden(eng, qx, qy, rects, *extra)
    assert set(got) == set(golden)                   # all 11 keys
    for key in golden:
        assert got[key] == golden[key], key
    full = eng.join_count(*extra[3:], mode="full")
    assert full.tolist() == golden["join_count"]


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_cache_keys_carry_backend(golden_index, backend):
    """tests/test_backends.py: every cached program's key names the
    executor's backend, and none is query-sharded (one device)."""
    idx, qx, qy, rects = golden_index
    ex = Executor(idx, EngineConfig(backend=backend), device="cpu")
    ex.run(RangeCount(), rects)
    keys = ex.cache_keys()
    assert keys and all(k[0] == ex.backend.name == "torch" for k in keys)
    assert all(not k[1] for k in keys)
    assert ex.stats()["qshard_executables"] == 0


# -- against the JAX engine on taxi 30k points / 16 partitions ----------

@pytest.fixture(scope="module")
def taxi():
    from repro.core import SpatialEngine as JEngine
    from repro.core import build_index as j_build, fit as j_fit

    x, y = ds.make("taxi", 30000, seed=0)
    rng = np.random.default_rng(21)
    ix = rng.integers(0, len(x), 128)
    qx = np.concatenate([x[ix], rng.random(128).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(128).astype(np.float32)])
    rects = np.concatenate([
        ds.random_rects(96, 1e-4, (0, 0, 1, 1), seed=1, centers=(x, y)),
        ds.random_rects(32, 1e-2, (0, 0, 1, 1), seed=2)])
    jidx = j_build(x, y, j_fit("kdtree", x, y, 16, seed=0))
    jeng = JEngine(jidx)
    assert jeng.backend == "xla"
    want = {"point": np.asarray(jeng.point_query(qx, qy)),
            "range_count": np.asarray(jeng.range_count(rects))}
    for k in (1, 10):
        d2, vid = jeng.knn(qx[:64], qy[:64], k, mode="exact")
        want[f"knn{k}"] = (np.asarray(d2), np.asarray(vid))
    cx, cy, cr, polys, ne = _taxi_extra(x, y)
    for name, out in adaptive_calls(jeng, rects, cx, cy, cr, qx, qy, polys,
                                    ne).items():
        want[name] = tuple(map(np.asarray, out))
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    static = dict(eps=jidx.eps, radix_bits=jidx.radix_bits,
                  probe=jidx.probe, overflow_pid=jidx.overflow_pid,
                  key_spec=jidx.key_spec)
    return x, y, qx, qy, rects, want, leaves, static


def _taxi_extra(x, y):
    rng = np.random.default_rng(22)
    ix = rng.integers(0, len(x), 64)
    cx, cy = x[ix].copy(), y[ix].copy()
    cr = rng.uniform(0.001, 0.03, 64).astype(np.float32)
    polys, ne = ds.random_polygons(16, (0.05, 0.05, 0.95, 0.95), seed=23,
                                   radius=0.05)
    return cx, cy, cr, polys, ne


def adaptive_calls(eng, rects, cx, cy, cr, qx, qy, polys, ne) -> dict:
    """The adaptive facade calls and full join, as tuples of arrays."""
    def tup(v):
        return v if isinstance(v, tuple) else (v,)

    return {"range_query": tup(eng.range_query(rects)),
            "circle_count": tup(eng.circle_count(cx, cy, cr)),
            "circle_query": tup(eng.circle_query(cx, cy, cr)),
            "knn_pruned": tup(eng.knn(qx[:96], qy[:96], 7)),
            "join": tup(eng.join_count(polys, ne)),
            "join_full": tup(eng.join_count(polys, ne, mode="full"))}


def _port_index(taxi, source):
    x, y, _, _, _, _, leaves, static = taxi
    if source == "port_build":
        return build_index(x, y, fit("kdtree", x, y, 16, seed=0),
                           device="cpu")
    return convert.index_from_arrays(leaves, device="cpu", **static)


@pytest.mark.parametrize("source", ["port_build", "converted"])
def test_matches_jax_engine_taxi(taxi, source):
    _, _, qx, qy, rects, want, _, _ = taxi
    eng = SpatialEngine(_port_index(taxi, source), device="cpu")
    found = eng.point_query(qx, qy).numpy()
    assert np.array_equal(found, want["point"])
    assert found[:128].all()                 # data points are found
    counts = eng.range_count(rects).numpy()
    assert np.array_equal(counts, want["range_count"])
    for k in (1, 10):
        d2, vid = eng.knn(qx[:64], qy[:64], k, mode="exact")
        assert np.array_equal(d2.numpy(), want[f"knn{k}"][0])
        assert np.array_equal(vid.numpy(), want[f"knn{k}"][1])
    x, y = taxi[0], taxi[1]
    got = adaptive_calls(eng, rects, *_taxi_extra(x, y)[:3], qx, qy,
                         *_taxi_extra(x, y)[3:])
    for name, out in got.items():
        assert len(out) == len(want[name]), name
        for g, w in zip(out, want[name]):
            assert np.array_equal(g.numpy(), w), name
    assert np.array_equal(got["join"][0].numpy(), got["join_full"][0].numpy())
    assert got["range_query"][2].all() and got["circle_query"][2].any()


def test_against_brute_force_oracle(taxi):
    from conftest import knn_oracle, range_oracle

    x, y, qx, qy, rects, _, _, _ = taxi
    eng = SpatialEngine(_port_index(taxi, "port_build"), device="cpu")
    assert np.array_equal(eng.range_count(rects[:64]).numpy(),
                          range_oracle(x, y, rects[:64]))
    d2, vid = eng.knn(qx[:32], qy[:32], 10, mode="exact")
    assert np.allclose(d2.numpy(), knn_oracle(x, y, qx[:32], qy[:32], 10),
                       rtol=1e-6, atol=0)   # f32 vs the oracle's f32 order
    for i in range(32):
        v = vid[i].numpy()
        dd = (x[v] - qx[i]) ** 2 + (y[v] - qy[i]) ** 2
        assert np.allclose(dd, d2[i].numpy(), rtol=1e-6)
    pts = set(zip(x.tolist(), y.tolist()))
    truth = [(a, b) in pts for a, b in zip(qx.tolist(), qy.tolist())]
    assert eng.point_query(qx, qy).tolist() == truth


def test_executor_run_batch_and_dispatches(golden_index):
    idx, qx, qy, rects = golden_index
    ex = Executor(idx, device="cpu")
    out = ex.run_batch([(PointQuery(), qx, qy), (RangeCount(), rects),
                        (Knn(k=2, mode="exact"), qx[:4], qy[:4])])
    assert ex.dispatches == 3 and len(out) == 3
    # torch tensors in, same answers out
    again = ex.run(RangeCount(), torch.from_numpy(rects), strict=True)
    assert torch.equal(again, out[1])


FAMILIES = pytest.mark.parametrize("spec,args", [
    (Knn(k=3), 2), (RangeQuery(), 1), (CircleQuery(), 3),
    (SpatialJoin(), 2)], ids=["knn_pruned", "range", "circle", "join"])


def _family_data(golden_index, spec, width: int):
    """The golden inputs of ``spec``'s family, tiled or cut to ``width``
    queries (polygons for the join)."""
    _, qx, qy, rects = golden_index
    cx, cy, cr, polys, ne = golden_extra(*golden_inputs()[:3])
    data = {RangeQuery: (rects,), CircleQuery: (cx, cy, cr),
            Knn: (qx, qy), SpatialJoin: (polys, ne)}[type(spec)]
    return tuple(np.resize(a, (width,) + a.shape[1:]) for a in data)


@pytest.fixture(scope="module")
def jax_golden_index():
    from gen_golden import build_inputs
    return build_inputs()[2]


@FAMILIES
def test_strict_false_on_a_sticky_tier_matches_jax(golden_index,
                                                    jax_golden_index, spec,
                                                    args):
    """strict=False with no sticky tier runs the strict loop, as the
    reference does; once a tier is sticky it is serving mode's fused
    program, with no host sync. Each call is bitwise the JAX package's,
    with the same host_syncs and sticky tiers."""
    from repro import core as J

    idx = golden_index[0]
    data = _family_data(golden_index, spec, 16)
    assert len(data) == args
    jspec = getattr(J, type(spec).__name__)(**{
        f.name: getattr(spec, f.name)
        for f in spec.__dataclass_fields__.values()})
    ex, jex = Executor(idx, device="cpu"), J.Executor(jax_golden_index)
    for strict in (False, False, True, False):
        syncs = ex.host_syncs
        got, want = ex.run(spec, *data, strict=strict), jex.run(
            jspec, *data, strict=strict)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert np.asarray(w).tobytes() == g.numpy().tobytes()
        assert ex.host_syncs == jex.host_syncs
        assert ex._sticky == jex._sticky
        assert spec.sticky_key() in ex._sticky
        if not strict and syncs:                # a steady serving call
            assert ex.host_syncs == syncs


@FAMILIES
def test_strict_false_wide_batch_on_a_sticky_tier_is_bucketed(
        golden_index, jax_golden_index, spec, args):
    """A serving batch of >= tier_bucket_min (32) queries on a sticky
    tier takes the tier-bucketed dispatch: bitwise the JAX Executor's
    run of the same batch, host_syncs +0 and probe_syncs +1 on both.
    Narrower batches skip the probe; strict calls and tier_buckets=False
    are served as before, with no probe."""
    from repro import core as J

    idx = golden_index[0]
    wide = _family_data(golden_index, spec, 32)
    assert len(wide) == args
    jspec = getattr(J, type(spec).__name__)(**{
        f.name: getattr(spec, f.name)
        for f in spec.__dataclass_fields__.values()})
    ex, jex = Executor(idx, device="cpu"), J.Executor(jax_golden_index)

    def both(data, **kw):
        got, want = ex.run(spec, *data, **kw), jex.run(jspec, *data, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert np.asarray(w).tobytes() == g.numpy().tobytes()
        for name in ("host_syncs", "probe_syncs", "dispatches"):
            assert getattr(ex, name) == getattr(jex, name), name
        assert ex._sticky == jex._sticky

    both(wide, strict=True)                         # a sticky tier
    assert spec.sticky_key() in ex._sticky
    syncs, probes = ex.host_syncs, ex.probe_syncs
    both(wide)                                      # bucketed
    assert ex.host_syncs == syncs and ex.probe_syncs == probes + 1
    both(tuple(a[:31] for a in wide))               # narrower: no probe
    assert ex.host_syncs == syncs and ex.probe_syncs == probes + 1
    both(wide, strict=True)                         # strict still runs
    off = Executor(idx, EngineConfig(tier_buckets=False), device="cpu")
    off.run(spec, *wide, strict=True)
    syncs = off.host_syncs
    off.run(spec, *wide)                            # served, no sync
    assert off.host_syncs == syncs and off.probe_syncs == 0


def test_strict_loop_escalates_then_sticks(golden_index, golden):
    idx, _, _, _ = golden_index
    cx, cy, cr, _, _ = golden_extra(*golden_inputs()[:3])
    ex = Executor(idx, device="cpu")
    n0 = ex.dispatches
    assert ex.run(CircleQuery(), cx, cy, cr,
                  strict=True).tolist() == golden["circle_count"]
    tiers = ex.dispatches - n0
    sticky = ex._sticky[("circle", False)]
    assert tiers == 3 and sticky == (1024, 16)      # (64,8) (256,16) ...
    n0 = ex.dispatches
    again = ex.run(CircleQuery(), cx, cy, cr, strict=True)
    assert ex.dispatches - n0 == 1                  # starts at the sticky
    assert again.tolist() == golden["circle_count"]
    # the materializing circle keeps its own tier state
    assert ("circle", True) not in ex._sticky


def test_range_cap_override_leaves_sticky_state(golden_index, golden):
    idx, _, _, rects = golden_index
    ex = Executor(idx, device="cpu")
    cnt, _, _ = ex.run(RangeQuery(cap=16), rects, strict=True)
    assert cnt.tolist() == golden["range_query_cnt"]
    # (16, 8) overflows, then (64, 16): the override's own ladder
    assert ex._sticky == {} and ex.dispatches == 2
    ex.run(RangeQuery(), rects, strict=True)
    assert ex._sticky == {("range",): (64, 8)}
    n0 = ex.dispatches
    cnt, vids, ok = ex.run(RangeQuery(cap=16), rects, strict=True)
    assert ex._sticky == {("range",): (64, 8)}      # unchanged
    assert cnt.tolist() == golden["range_query_cnt"]
    assert ex.dispatches - n0 == 2                  # (16, 8), (64, 16)


def test_knn_r0_bitwise():
    """The pruned kNN's initial radius, bitwise the reference's (a host
    float64 estimate beside eager float32 device math)."""
    from repro.core import Executor as JExecutor
    from repro.core import build_index as j_build, fit as j_fit
    import jax.numpy as jnp

    x, y = ds.make("taxi", 8000, seed=4)
    rng = np.random.default_rng(3)
    qx = np.concatenate([x[:200], rng.uniform(-0.5, 1.5, 56)]).astype(
        np.float32)
    qy = np.concatenate([y[:200], rng.uniform(-0.5, 1.5, 56)]).astype(
        np.float32)
    jex = JExecutor(j_build(x, y, j_fit("kdtree", x, y, 10, seed=0)))
    ex = Executor(build_index(x, y, fit("kdtree", x, y, 10, seed=0),
                              device="cpu"), device="cpu")
    for k in (1, 10, 64):
        want = np.asarray(jex._knn_r0(jnp.asarray(qx), jnp.asarray(qy), k))
        got = ex._knn_r0(torch.from_numpy(qx), torch.from_numpy(qy), k)
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), k


def test_engine_config_and_spec_validation(golden_index):
    idx, qx, qy, _ = golden_index
    with pytest.raises(ValueError):
        EngineConfig(backend="pallas")
    with pytest.raises(ValueError):          # kernels need a CUDA device
        SpatialEngine(idx, EngineConfig(backend="cuda"), device="cpu")
    with pytest.raises(ValueError):
        SpatialJoin(mode="sideways")
    with pytest.raises(ValueError):
        Knn(k=3, mode="approx")
    assert CircleQuery(materialize=1) == CircleQuery(materialize=True)
    assert Knn(k=3).sticky_key() == Knn(k=3, mode="exact").sticky_key()
    assert RangeQuery(cap=8).sticky_key() == RangeQuery().sticky_key()
    cfg = TConfig()
    assert (cfg.range_cap, cfg.knn_cap, cfg.join_cap, cfg.circle_cap,
            cfg.knn_max_rounds, cfg.scan_chunk_elems) == (64, 64, 128, 64,
                                                          24, 1 << 26)
    with pytest.raises(TypeError):
        Executor(idx, device="cpu").run(Knn(k=3), qx)
