"""The port's wide-batch tier-bucketed dispatch (DESIGN.md §13), bitwise
against the JAX package on the CPU.

Ported from the xla cases of tests/test_bucketed.py, on its fixture
(taxi 20,000 points, kdtree 24, ``_mixed_queries``' batches that mix
escalation tiers: tiny windows next to near-global ones, so several
buckets form). A wide non-strict batch on a sticky tier runs the need
probe, one host read of the bucket sizes (``probe_syncs``, not
``host_syncs``), and one fused call per bucket (and row chunk). Checked:

  * every wide output bitwise the JAX Executor's bucketed run and, row by
    row, the port's own per-query serial run;
  * after every call, ``host_syncs``, ``probe_syncs``, ``dispatches``,
    the sticky tiers and the stashed tiers equal the JAX Executor's;
  * the need probes' outputs bitwise the JAX programs';
  * several buckets form; a narrow batch skips the probe; with
    ``row_chunk_elems=1`` the chunked run equals the unchunked one;
  * after every call, the program-cache keys (backend names mapped) and
    ``cache_size`` equal the JAX Executor's, and the need probes are
    cached once per base (``test_probe_executables_cached_per_base``).
"""
import numpy as np
import pytest
import torch

from repro import core as J
from repro.data import spatial as jds
from repro_torch import core as T
from repro_torch.core import local_ops as TL

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

N = 20000
NAMES = ["range", "circle", "circle_mat", "knn5", "join"]


@pytest.fixture(scope="module")
def built():
    x, y = jds.make("taxi", N, seed=2)
    jpart = J.fit("kdtree", x, y, 24)
    tidx = T.build_index(x, y, T.fit("kdtree", x, y, 24), device="cpu")
    return x, y, jpart, J.build_index(x, y, jpart), tidx


def _mixed_queries(x, y, part, pkg, n_q=40):
    """tests/test_bucketed.py's query sets: mostly tiny, a few huge."""
    rng = np.random.default_rng(0)
    ix = rng.integers(0, len(x), n_q)
    qx = x[ix].astype(np.float32)
    qy = y[ix].astype(np.float32)
    rects = np.asarray(jds.random_rects(n_q, 1e-3, part.bounds, seed=3,
                                        centers=(x, y)))
    rects[:6] = np.asarray(jds.random_rects(6, 0.3, part.bounds, seed=4,
                                            centers=(x, y)))
    r = np.full(n_q, 2e-3, np.float32)
    r[:5] = 0.25
    polys, ne = jds.random_polygons(n_q, part.bounds, seed=5)
    return {"range": (pkg.RangeQuery(), (rects,)),
            "circle": (pkg.CircleQuery(), (qx, qy, r)),
            "circle_mat": (pkg.CircleQuery(materialize=True), (qx, qy, r)),
            "knn5": (pkg.Knn(k=5), (qx, qy)),
            "join": (pkg.SpatialJoin(), (polys, ne))}


class Pair:
    """The JAX and the port executor, warmed alike, driven in lockstep."""

    def __init__(self, jex, tex, x, y, part, names=NAMES):
        self.j, self.t = jex, tex
        self.jq = _mixed_queries(x, y, part, J)
        self.tq = _mixed_queries(x, y, part, T)
        for name in names:               # the strict warm-up: sticky tiers
            self.run(name, strict=True)
        assert self.j.maintain() == self.t.maintain()
        self.check("warm-up")

    def check(self, what):
        j, t = self.j, self.t
        assert j.host_syncs == t.host_syncs, what
        assert j.probe_syncs == t.probe_syncs, what
        assert j.dispatches == t.dispatches, what
        assert j._sticky == t._sticky, what
        assert ({b: v[0] for b, v in j._pending.items()} ==
                {b: v[0] for b, v in t._pending.items()}), what
        st = t.stats()
        assert st["probe_syncs"] == t.probe_syncs == j.stats()["probe_syncs"]
        # the program caches hold the same keys (backend names mapped)
        names = {"xla": "torch"}
        assert ({(names.get(k[0], k[0]),) + k[1:] for k in j.cache_keys()}
                == set(t.cache_keys())), what
        assert st["cache_size"] == j.stats()["cache_size"], what

    def run(self, name, rows=None, strict=False, repeat=1):
        """One call of family ``name`` on both (rows ``rows`` of its
        batch, tiled ``repeat`` times): outputs compared bitwise."""
        out = []
        for ex, qs in ((self.j, self.jq), (self.t, self.tq)):
            spec, args = qs[name]
            if rows is not None:
                args = tuple(a[rows] for a in args)
            args = tuple(np.concatenate([a] * repeat) for a in args)
            res = ex.run(spec, *args, strict=strict)
            out.append(res if isinstance(res, tuple) else (res,))
        for a, b in zip(*out, strict=True):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        self.check(name)
        return out[1]


@pytest.fixture(scope="module")
def pair(built):
    x, y, jpart, jidx, tidx = built
    return Pair(J.Executor(jidx), T.Executor(tidx, device="cpu"), x, y,
                jpart)


@pytest.mark.parametrize("name", NAMES)
def test_bucketed_bitwise_vs_serial_and_jax(pair, name):
    """The wide call: bitwise the JAX Executor's, with host_syncs +0 and
    probe_syncs +1 on both; each row bitwise the port's own per-query
    serial call (which the JAX Executor runs too, in lockstep)."""
    n = pair.tq[name][1][0].shape[0]
    serial = [pair.run(name, rows=slice(i, i + 1)) for i in range(n)]
    hs, ps = pair.t.host_syncs, pair.t.probe_syncs
    wide = pair.run(name)
    assert pair.t.host_syncs == hs and pair.t.probe_syncs == ps + 1
    for i, s in enumerate(serial):
        for a, b in zip(s, wide, strict=True):
            assert torch.equal(a, b[i:i + 1]), (name, i)


@pytest.mark.parametrize("name", NAMES)
def test_bucketed_forms_multiple_buckets(pair, name):
    """The mixed-tier batches split: at least one fused call besides the
    probe, at least two for the materializing families (the same number
    as the JAX Executor's, which ``Pair.check`` holds)."""
    d0 = pair.t.dispatches
    pair.run(name)
    calls = pair.t.dispatches - d0 - 1              # minus the probe
    assert calls >= (2 if name in ("range", "circle_mat") else 1), calls


@pytest.mark.parametrize("name", NAMES)
def test_narrow_batches_skip_the_probe(pair, name):
    ps = pair.t.probe_syncs
    pair.run(name, rows=slice(0, 4))                # below tier_bucket_min
    assert pair.t.probe_syncs == ps


@pytest.mark.parametrize("name", NAMES)
def test_need_probe_bitwise_jax(pair, name):
    """The probe program's output (the first call of a wide run: (Q, 3)
    for the rect families, (Q, J, 3) for kNN) bitwise the JAX
    program's."""
    calls = {"j": [], "t": []}
    for key, ex in (("j", pair.j), ("t", pair.t)):
        def spy(fn, *args, _real=ex._call, _log=calls[key]):
            out = _real(fn, *args)
            _log.append((fn, out))
            return out

        ex._call = spy                  # the instance's, over the method
    try:
        pair.run(name)
    finally:
        del pair.j._call, pair.t._call
    (tfn, tout), (_, jout) = calls["t"][0], calls["j"][0]
    # the cached dispatcher of the probe program (exec_key tag "p")
    assert tfn.key[3] == "p"
    assert isinstance(tfn.fn, (TL._WindowNeedLocal, TL._KnnNeedLocal))
    jout = np.asarray(jout)
    assert jout.dtype == np.int32 and jout.shape == tuple(tout.shape)
    assert jout.tobytes() == tout.numpy().tobytes()
    assert tout.shape[-1] == 3 and tout.dim() == (3 if name == "knn5"
                                                  else 2)


def test_probe_executables_cached_per_base(pair):
    """One need-probe program per base, never query-sharded, the same
    keys as the JAX Executor's (tests/test_bucketed.py)."""
    for name in NAMES:
        pair.run(name)
    probes = [k for k in pair.t.cache_keys() if k[3] == "p"]
    assert len(probes) >= 4        # range/circle x2/knn/join bases
    assert all(not k[1] for k in probes)
    assert len({k[2] for k in probes}) == len(probes)
    want = {("torch",) + k[1:] for k in pair.j.cache_keys() if k[3] == "p"}
    assert set(probes) == want


def test_row_chunked_dispatch_equals_unchunked(built, pair):
    """A wide bucket past the row_chunk_elems budget splits into equal
    chunk calls (a short tail padded by its own row 0): bitwise the
    unchunked result and the JAX Executor's, with its dispatch count.
    Sixteen copies of the range batch put more than 256 rows (the
    chunk's floor) in one bucket."""
    x, y, jpart, jidx, tidx = built
    base = pair.run("range", repeat=16)
    cfg = dict(row_chunk_elems=1)
    chunked = Pair(J.Executor(jidx, config=J.EngineConfig(**cfg)),
                   T.Executor(tidx, config=T.EngineConfig(**cfg),
                              device="cpu"), x, y, jpart, names=["range"])
    d0, d1 = chunked.t.dispatches, pair.t.dispatches
    out = chunked.run("range", repeat=16)
    pair.run("range", repeat=16)
    # more calls than the unchunked run: a bucket went in chunks
    assert chunked.t.dispatches - d0 > pair.t.dispatches - d1
    for a, b in zip(base, out, strict=True):
        assert torch.equal(a, b)


def test_maintain_reads_the_bucketed_flags(pair):
    """The bucketed call stashes (sticky, ok) for maintain(), which
    moves the tiers as the JAX Executor's does."""
    for name in NAMES:
        pair.run(name)
    assert pair.j.maintain() == pair.t.maintain()
    pair.check("maintain")
