"""Port parity: partitioners, spline, radix table and every index leaf,
bitwise against the JAX package on the same numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build
from repro.core import partitioner as JP
from repro.core.build import assign_partitions as j_assign
from repro.core.radix import build_radix as j_radix
from repro.core.spline import build_spline as j_spline
from repro.data import spatial as jds
from repro_torch.core import build as TB
from repro_torch.core import partitioner as TP
from repro_torch.core.radix import build_radix as t_radix
from repro_torch.core.spline import build_spline as t_spline
from repro_torch.data import spatial as tds

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

LEAVES = TB.LEAVES


def test_data_generators_identical():
    for kind in ("uniform", "gaussian", "taxi"):
        a = jds.make(kind, 3000, seed=4)
        b = tds.make(kind, 3000, seed=4)
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    x, y = jds.make("taxi", 500, seed=1)
    assert np.array_equal(
        jds.random_rects(64, 1e-3, (0, 0, 1, 1), seed=3, centers=(x, y)),
        tds.random_rects(64, 1e-3, (0, 0, 1, 1), seed=3, centers=(x, y)))


@pytest.mark.parametrize("kind", sorted(JP.STRATEGIES))
@pytest.mark.parametrize("nparts", [1, 7, 16])
def test_partitioner_boxes_bitwise(kind, nparts):
    x, y = jds.make("taxi", 20000, seed=nparts)
    a = JP.fit(kind, x, y, nparts, seed=3)
    b = TP.fit(kind, x, y, nparts, seed=3)
    assert a.kind == b.kind and a.bounds == b.bounds
    assert np.array_equal(a.partition_bounds(), b.partition_bounds())


def test_assign_partitions_bitwise():
    x, y = jds.make("gaussian", 20000, seed=2)
    part = JP.fit("rtree", x, y, 9, seed=0)       # leaves gaps: overflow
    boxes = part.partition_bounds()[:-1]
    want = np.asarray(j_assign(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(boxes)))
    got = TB.assign_partitions(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(boxes), chunk=4096)
    assert (want == len(boxes)).any()
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _spline_case(keys, eps, m_pad=None):
    keys = np.asarray(keys, np.int64)
    kf = keys.astype(np.float32)
    n = len(kf)
    m_pad = m_pad or n + 2
    want = j_spline(jnp.asarray(kf), jnp.ones(n, bool), eps=eps,
                    m_pad=m_pad)
    got = t_spline(kf[None, :], np.ones((1, n), bool), eps=eps,
                   m_pad=m_pad)
    for name in ("knot_keys", "knot_pos", "n_knots", "max_run",
                 "overflow"):
        assert np.array_equal(got[name][0], np.asarray(want[name])), name
    return got


@pytest.mark.parametrize("case", [
    ("falsified_duplicates", [0] * 17 + [86623, 130055], 4),
    ("single_key", [5, 5, 5], 2),
    ("runs", [1, 1, 1, 2, 3, 3, 7, 7, 7, 7, 9], 4),
    ("two_keys", [3, 4], 1),
], ids=lambda c: c[0])
def test_spline_edge_cases_bitwise(case):
    _, keys, eps = case
    _spline_case(keys, eps)


@pytest.mark.parametrize("seed", range(6))
def test_spline_random_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 3000))
    keys = np.sort(rng.integers(0, 1 << int(rng.integers(4, 23)), n))
    got = _spline_case(keys, eps=int(rng.choice([0, 1, 4, 32])))
    assert got["n_knots"][0] >= 2


def test_spline_overflow_flag_bitwise():
    rng = np.random.default_rng(0)
    got = _spline_case(np.cumsum(rng.integers(1, 9, 100)), eps=0, m_pad=10)
    assert got["overflow"][0]


def test_spline_partitions_vectorized_with_padding():
    """Rows of different valid lengths (and an empty row) fit at once
    equal each row fit alone by the reference."""
    rng = np.random.default_rng(9)
    n, counts = 700, [700, 311, 0, 1, 2]
    kf = np.full((len(counts), n), 3.0e38, np.float32)
    valid = np.arange(n)[None, :] < np.asarray(counts)[:, None]
    for r, c in enumerate(counts):
        kf[r, :c] = np.sort(rng.integers(0, 1 << 20, c)).astype(np.float32)
    got = t_spline(kf, valid, eps=8, m_pad=n)
    for r in range(len(counts)):
        want = j_spline(jnp.asarray(kf[r]), jnp.asarray(valid[r]), eps=8,
                        m_pad=n)
        for name in ("knot_keys", "knot_pos", "n_knots", "max_run"):
            assert np.array_equal(got[name][r], np.asarray(want[name]))
        rx_w = j_radix(want["knot_keys"], want["n_knots"], bits=10)
        rx_g = t_radix(got["knot_keys"][r:r + 1], got["n_knots"][r:r + 1],
                       bits=10)
        for name in ("table", "kmin", "scale"):
            assert np.array_equal(rx_g[name][0], np.asarray(rx_w[name]))


@pytest.mark.parametrize("data,n,parts,kind,kw", [
    ("gaussian", 12000, 12, "kdtree", {}),            # golden inputs
    ("taxi", 30000, 16, "kdtree", {}),
    ("uniform", 8000, 9, "rtree", {"eps": 8}),
    ("taxi", 6000, 4, "quadtree", {"radix_bits": 6}),
], ids=["golden", "taxi30k", "uniform_rtree_eps8", "taxi_quadtree_b6"])
def test_index_leaves_bitwise(data, n, parts, kind, kw):
    x, y = jds.make(data, n, seed=7 if data == "gaussian" else 0)
    jp = JP.fit(kind, x, y, parts, seed=0)
    tp = TP.fit(kind, x, y, parts, seed=0)
    want = j_build(x, y, jp, **kw)
    got = TB.build_index(x, y, tp, device="cpu", **kw)
    for name in LEAVES:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        if name in ("key", "delta_key"):      # uint32 keys, held as int64
            a = a.astype(np.int64)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for attr in ("eps", "radix_bits", "probe", "overflow_pid", "n_pad",
                 "num_partitions"):
        assert getattr(want, attr) == getattr(got, attr), attr


def test_build_with_vid_override():
    x, y = jds.make("uniform", 3000, seed=5)
    vid = np.arange(3000)[::-1] * 3
    jp = JP.fit("kdtree", x, y, 5, seed=0)
    want = j_build(x, y, jp, vid=vid)
    got = TB.build_index(x, y, TP.fit("kdtree", x, y, 5, seed=0), vid=vid,
                         device="cpu")
    assert np.array_equal(np.asarray(want.vid), got.vid.numpy())


def test_probe_for_matches():
    from repro.core.build import probe_for as j_probe
    for eps, run, n_pad in [(32, 1, 4096), (4, 17, 128), (32, 5000, 2048)]:
        assert TB.probe_for(eps, run, n_pad) == j_probe(eps, run, n_pad)


def test_index_to_and_size_bytes():
    x, y = jds.make("uniform", 2000, seed=1)
    idx = TB.build_index(x, y, TP.fit("kdtree", x, y, 4), device="cpu")
    moved = idx.to("cpu")
    assert all(torch.equal(getattr(idx, n), getattr(moved, n))
               for n in LEAVES)
    assert idx.size_bytes()["global_index"] == 5 * 4 * 4
