"""Port parity of the slice end to end: SpatialEngine point_query,
range_count and knn(mode="exact") on the CPU, bitwise against the golden
fixture and against the JAX SpatialEngine (xla backend), both on the
port's own build and on the JAX index carried over with
``convert.index_from_arrays``."""
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
from repro_torch.data import spatial as ds

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
    assert eng.point_query(qx, qy).tolist() == golden["point"]
    assert eng.range_count(rects).tolist() == golden["range_count"]
    d2, vid = eng.knn(qx[:8], qy[:8], 3, mode="exact")
    assert d2.dtype == torch.float32 and vid.dtype == torch.int32
    assert d2.tolist() == golden["knn_exact_d2"]
    assert vid.tolist() == golden["knn_exact_vid"]


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
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    static = dict(eps=jidx.eps, radix_bits=jidx.radix_bits,
                  probe=jidx.probe, overflow_pid=jidx.overflow_pid,
                  key_spec=jidx.key_spec)
    return x, y, qx, qy, rects, want, leaves, static


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


@pytest.mark.parametrize("spec,args", [
    (Knn(k=3), 2), (RangeQuery(), 1), (CircleQuery(), 3),
    (SpatialJoin(), 2)], ids=["knn_pruned", "range", "circle", "join"])
def test_unported_specs_raise(golden_index, spec, args):
    idx, qx, _, _ = golden_index
    ex = Executor(idx, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ex.run(spec, *([qx] * args))


def test_engine_rejects_pruned_knn_and_bad_config(golden_index):
    idx, qx, qy, _ = golden_index
    eng = SpatialEngine(idx, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.knn(qx, qy, 3)
    with pytest.raises(ValueError):
        EngineConfig(backend="pallas")
    with pytest.raises(ValueError):          # kernels need a CUDA device
        SpatialEngine(idx, EngineConfig(backend="cuda"), device="cpu")
