"""Warm start of the port on the CPU (DESIGN.md §14), against the JAX
package.

Ported from tests/test_compile_cache.py:

  hygiene      ``test_lru_eviction_by_mtime`` on the port's
               ``CompileCache``, and an executor with a tiny
               ``compile_cache_bytes`` keeping its entries under the cap;
  fallback     a corrupt entry, and a schema mismatch, on the
               kernel-library store: a fake ``nvcc`` on PATH writes its
               ``-o`` file, so ``_build.build_all`` runs without CUDA. A
               corrupt entry is invalidated, rebuilt, re-billed as a miss
               and healed for the next process; a mismatched one is
               unreachable;
  neutrality   manifest prewarm realizes every recorded program, and the
               recorded traffic then adds no cached program and no
               signature;
  parity       a restart in a subprocess (``manifest`` ->
               ``save_manifest`` -> a fresh process, ``prewarm(...,
               exercise=True)``) answers bitwise as the first process and
               as the JAX Executor.

Added: the cache itself against the JAX Executor (xla backend) on the
same traffic: ``cache_keys()``, ``cache_variants()`` and
``stats()["cache_size"]`` after a strict escalation, a sticky move, a
bucketed wide call, an insert and a capacity growth (backend names
mapped: xla -> torch); ``manifest()`` equal to the reference's under the
one dtype mapping, the index key: int64 in the port, uint32 in the
reference (ROADMAP "Bitwise hazards"), in the update programs' key
arguments.

Ported elsewhere: ``test_async_precompile_is_bitwise_neutral`` (the
precompile worker) is in tests/test_torch_precompile.py. Not ported: the
reference's restart case on the pallas backend (the Pallas kernels cannot run on this jax, ROADMAP §3). On the
CPU no kernel library is loaded, so the prewarm and restart tests do not
count disk hits (the card's restart in chip_smoke.py does).
"""
import json
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import core as J
from repro.data import spatial as jds
from repro_torch import core as T
from repro_torch.core import plan as TP
from repro_torch.core.compile_cache import (CompileCache, load_manifest,
                                            process_context, save_manifest)
from repro_torch.data import spatial as ds
from repro_torch.kernels import _build
from repro_torch.serve import SpatialServeSession as TSession

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

N = 2000
CPU = dict(device="cpu")
SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def _data():
    """Deterministic tiny data set, rebuilt bit-identically by the
    restart subprocess from the same seeds."""
    x, y = ds.make("gaussian", N, seed=3)
    return x, y, T.fit("kdtree", x, y, 4, seed=0)


def _workload(x, y, part, pkg):
    """One named request per query spec (every dispatch family)."""
    rng = np.random.default_rng(11)
    ix = rng.integers(0, len(x), 5)
    rects = ds.random_rects(5, 1e-3, part.bounds, seed=12, centers=(x, y))
    polys, ne = ds.random_polygons(4, part.bounds, seed=13)
    r = np.full(5, 0.03, np.float32)
    return [("point", pkg.PointQuery(), (x[ix], y[ix])),
            ("range_count", pkg.RangeCount(), (rects,)),
            ("range", pkg.RangeQuery(), (rects,)),
            ("circle", pkg.CircleQuery(), (x[ix], y[ix], r)),
            ("circle_mat", pkg.CircleQuery(materialize=True),
             (x[ix], y[ix], r)),
            ("knn", pkg.Knn(k=5), (x[ix], y[ix])),
            ("knn_exact", pkg.Knn(k=4, mode="exact"), (x[ix], y[ix])),
            ("join", pkg.SpatialJoin(), (polys, ne)),
            ("join_full", pkg.SpatialJoin(mode="full"), (polys, ne))]


def _leaves(res):
    return [np.asarray(v) for v in (res if isinstance(res, tuple)
                                    else (res,))]


def settle_and_serve(submit, maintain, reqs) -> dict:
    """The serving warm-up a live session sees: every request once
    (the strict loop settles the sticky tiers), maintain(), then every
    request again on the steady path; returns the second pass."""
    for _, spec, args in reqs:
        submit(spec, *args)
    maintain()
    return {name: _leaves(submit(spec, *args)) for name, spec, args in reqs}


def sig_count(ex) -> int:
    """Realized (program, signature) pairs of a port executor."""
    return sum(len(d.sigs()) for d in ex._cache.values())


def port_keys(jex) -> set:
    """The JAX executor's program-cache keys, xla named torch."""
    return {(("torch",) if k[0] == "xla" else (k[0],)) + k[1:]
            for k in jex.cache_keys()}


@pytest.fixture(scope="module")
def built():
    x, y, part = _data()
    return x, y, part, T.build_index(x, y, part, **CPU)


# -- size-capped LRU eviction -----------------------------------------

def test_lru_eviction_by_mtime(tmp_path):
    cc = CompileCache(tmp_path / "cc", max_bytes=1 << 30)
    blob = b"x" * 300
    for i, t in enumerate((100.0, 200.0, 300.0)):
        fp = f"{i:064d}"
        assert cc.store(fp, blob)
        os.utime(cc.path(fp), (t, t))
    # oldest-first: cap 650 keeps the two newest
    assert cc.evict(max_bytes=650) == 1
    assert cc.load("0" * 64) is None               # evicted -> miss
    assert cc.load(f"{1:064d}") == blob            # bumps mtime (LRU)
    # entry 1 was just USED, so the next sweep drops entry 2 instead
    assert cc.evict(max_bytes=350) == 1
    assert cc.load(f"{1:064d}") == blob
    assert cc.load(f"{2:064d}") is None
    assert cc.size_bytes() <= 350 and len(cc) == 1
    assert (cc.hits, cc.misses) == (2, 2)


# -- the kernel-library store, with a fake nvcc -------------------------

STUB_C = """const char *repro_error_string(int e) { (void)e; return "fake"; }
"""

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({stub!r}, "rb") as f:
    lib = f.read()
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(lib + b"library of " + args[-1].encode())
print("ptxas info    : fake")
"""


@pytest.fixture(scope="module")
def stub_library(tmp_path_factory):
    """A real shared library exporting ``repro_error_string`` (what
    ``_build.load`` binds besides the launchers), built with the C
    compiler: the fake nvcc's libraries load with ``ctypes``."""
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.c").write_text(STUB_C)
    subprocess.run([shutil.which("cc") or "cc", "-shared", "-fPIC", "-o",
                    str(d / "libstub.so"), str(d / "stub.c")], check=True)
    return d / "libstub.so"


def _restart(monkeypatch):
    """What a new process starts from: no library loaded, no store, the
    process-level counters at 0."""
    for name, value in (("_libs", {}), ("_store", None),
                        ("_looked_up", {}), ("disk_hits", 0),
                        ("disk_misses", 0), ("compiles", 0)):
        monkeypatch.setattr(_build, name, value)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch, stub_library):
    """A fake nvcc first on PATH (it writes the stub library, tagged
    with its source, to its ``-o`` file), a build directory in
    tmp_path, and the state of kernels/_build reset (restored
    afterwards)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     stub=str(stub_library)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _restart(monkeypatch)
    return tmp_path / "build"


def _counts():
    return _build.disk_hits, _build.disk_misses, _build.compiles


def _load_all():
    return {n: _build.load(n, {}) for n in SOURCES}


def test_store_keeps_each_library_once(fake_nvcc, built, tmp_path,
                                       monkeypatch):
    """A cold store misses and compiles each source once, into the
    store itself; a restart on it hits each once, loads each from there
    and runs no nvcc; stats() reads the counters; without a store the
    build directory serves and nothing is counted."""
    n = len(SOURCES)
    cache = tmp_path / "cache"
    ex = T.Executor(built[3], T.EngineConfig(compile_cache_dir=str(cache)),
                    **CPU)
    libs = _build.build_all()
    assert set(libs) == set(SOURCES)
    assert {p.parent for p in libs.values()} == {ex._disk.entries}
    assert _counts() == (0, n, n)
    assert len(ex._disk) == n
    st = ex.stats()
    assert (st["disk_cache_hits"], st["disk_cache_misses"]) == (0, n)
    want = {k: p.read_bytes() for k, p in libs.items()}

    _restart(monkeypatch)
    ex2 = T.Executor(built[3], T.EngineConfig(compile_cache_dir=str(cache)),
                     **CPU)
    assert _build.build_all() == libs
    _load_all()
    assert _counts() == (n, 0, 0)
    assert (ex2.stats()["disk_cache_hits"],
            ex2.stats()["disk_cache_misses"]) == (n, 0)
    assert {k: p.read_bytes() for k, p in libs.items()} == want
    assert not fake_nvcc.exists() or not list(fake_nvcc.glob("*.so"))
    # without a cache directory the counters read 0, as the reference's
    assert T.Executor(built[3], **CPU).stats()["disk_cache_hits"] == 0
    _restart(monkeypatch)
    plain = _build.build_all()
    assert {p.parent for p in plain.values()} == {fake_nvcc}
    assert _counts() == (0, 0, n)


def test_corrupt_entry_falls_back_and_heals(fake_nvcc, built, tmp_path,
                                            monkeypatch):
    """An entry that does not load is invalidated, rebuilt in its place,
    re-billed from a hit to a miss, and the next process hits it."""
    n = len(SOURCES)
    cache = tmp_path / "cache"
    cfg = T.EngineConfig(compile_cache_dir=str(cache))
    T.Executor(built[3], cfg, **CPU)
    want = {k: p.read_bytes() for k, p in _build.build_all().items()}
    entries = sorted((cache / "entries").glob("*.bin"))
    assert len(entries) == n
    for p in entries:
        p.write_bytes(b"not a kernel library")

    _restart(monkeypatch)
    ex2 = T.Executor(built[3], cfg, **CPU)
    _load_all()
    # every corrupt entry was found, failed to load, was re-billed
    # hit -> miss and rebuilt by one nvcc
    assert _counts() == (0, n, n)
    st = ex2.stats()
    assert (st["disk_cache_hits"], st["disk_cache_misses"]) == (0, n)
    assert {k: _build.lib_path(k).read_bytes() for k in SOURCES} == want
    # the rebuilds landed in the store: the next process hits every one
    _restart(monkeypatch)
    T.Executor(built[3], cfg, **CPU)
    _load_all()
    assert _counts() == (n, 0, 0)                     # no nvcc ran


def test_schema_mismatch_misses_cleanly(fake_nvcc, built, tmp_path,
                                        monkeypatch):
    """A store written under another schema is unreachable: fresh
    builds, the same libraries, no crash; the old entries stay (LRU)."""
    n = len(SOURCES)
    cache = tmp_path / "cache"
    cfg = T.EngineConfig(compile_cache_dir=str(cache))
    T.Executor(built[3], cfg, **CPU)
    want = {k: p.read_bytes() for k, p in _build.build_all().items()}
    assert _counts() == (0, n, n)
    monkeypatch.setattr(TP, "CACHE_SCHEMA", TP.CACHE_SCHEMA + 1)
    _restart(monkeypatch)
    ex2 = T.Executor(built[3], cfg, **CPU)
    assert ex2._disk.context["schema"] == TP.CACHE_SCHEMA
    got = {k: p.read_bytes() for k, p in _build.build_all().items()}
    assert _counts() == (0, n, n)
    assert got == want
    assert len(ex2._disk) == 2 * n


def test_executor_respects_size_cap(fake_nvcc, built, tmp_path,
                                    stub_library):
    size = stub_library.stat().st_size
    cap = size * 5 // 2
    ex = T.Executor(built[3], T.EngineConfig(
        compile_cache_dir=str(tmp_path / "cache"),
        compile_cache_bytes=cap), **CPU)
    _build.build_all()
    assert 0 < ex._disk.size_bytes() <= cap
    assert len(ex._disk) < len(SOURCES)


def test_process_context_on_the_cpu():
    ctx = process_context("cpu")
    assert ctx["schema"] == TP.CACHE_SCHEMA
    assert ctx["torch"] == torch.__version__
    assert ctx["device"] == "cpu" and ctx["device_count"] == 0
    fp = TP.cache_fingerprint(ctx, ("kernel", "morton"), ("abc",))
    assert fp == TP.cache_fingerprint(dict(ctx), ("kernel", "morton"),
                                      ("abc",))
    assert fp != TP.cache_fingerprint(ctx, ("kernel", "morton"), ("abd",))


# -- manifest prewarm -----------------------------------------------------

def test_prewarm_compiles_nothing_new_for_recorded_traffic(tmp_path,
                                                           built):
    x, y, part, index = built
    reqs = _workload(x, y, part, T)
    a = TSession(index, **CPU)
    settle_and_serve(a.submit, a.maintain, reqs)
    man = a.manifest()
    assert man["programs"], "manifest recorded no programs"
    mpath = tmp_path / "prewarm.json"
    save_manifest(mpath, man)
    man = load_manifest(mpath)          # across the JSON round-trip
    assert man == json.loads(json.dumps(a.manifest()))

    b = TSession(index, **CPU)
    res = b.prewarm(man)
    assert res["compiled"] == sig_count(a.executor) > 0
    assert res["skipped"] == 0
    st0, n0 = b.stats(), sig_count(b.executor)
    assert set(b.executor.cache_keys()) == set(a.executor.cache_keys())
    assert b.stats()["sticky"] == a.stats()["sticky"]
    for _, spec, args in reqs:
        b.submit(spec, *args)
    st1 = b.stats()
    # recorded traffic rides entirely on prewarmed programs
    assert st1["cache_size"] == st0["cache_size"]
    assert st1["compile_ms_total"] == st0["compile_ms_total"]
    assert sig_count(b.executor) == n0
    assert st1["host_syncs"] == st0["host_syncs"]   # sticky from the start
    assert b.prewarm(man)["compiled"] == 0           # nothing left to do


def test_release_drops_every_program(built):
    """``release()`` empties the program cache and keeps the sticky tiers
    and the index: the same traffic then answers bitwise as before,
    realizing only its steady programs again."""
    x, y, part, index = built
    reqs = _workload(x, y, part, T)
    s = TSession(index, **CPU)
    first = settle_and_serve(s.submit, s.maintain, reqs)
    n, sticky = s.stats()["cache_size"], s.stats()["sticky"]
    s.release()
    assert s.stats()["cache_size"] == 0 and s.executor.cache_keys() == []
    assert s.stats()["sticky"] == sticky
    again = {name: _leaves(s.submit(spec, *args)) for name, spec, args
             in reqs}
    for name, leaves in first.items():
        assert all(np.array_equal(a, b) for a, b in
                   zip(leaves, again[name], strict=True)), name
    assert 0 < s.stats()["cache_size"] <= n


# -- the cache against the JAX executor ------------------------------------

@pytest.fixture(scope="module")
def taxi():
    x, y = jds.make("taxi", 6000, seed=2)
    jpart = J.fit("kdtree", x, y, 12)
    return (x, y, jpart, J.build_index(x, y, jpart),
            T.build_index(x, y, T.fit("kdtree", x, y, 12), **CPU))


def test_cache_keys_match_jax_executor(taxi):
    """Strict escalation, sticky moves (maintain), a bucketed wide call,
    the exact families, inserts and a capacity growth: after each step
    the keys, the window variants and cache_size equal the JAX
    Executor's."""
    x, y, part, jidx, tidx = taxi
    cfg = dict(range_cap=2, range_cand=1, delta_cap=64)
    je = J.Executor(jidx, config=J.EngineConfig(**cfg))
    te = T.Executor(tidx, T.EngineConfig(**cfg), **CPU)
    bases = [("range",), ("circle", False), ("knn", 5), ("join",)]

    def both(fn):
        return fn(je, J), fn(te, T)

    def check(what):
        assert port_keys(je) == set(te.cache_keys()), what
        assert je.stats()["cache_size"] == te.stats()["cache_size"], what
        for base in bases:
            assert je.cache_variants(base) == te.cache_variants(base), what

    for sel in (1e-6, 1e-4, 1e-3, 1e-2):            # strict escalation
        rects = ds.random_rects(6, sel, part.bounds, seed=int(sel * 1e7),
                                centers=(x, y))
        both(lambda e, M: e.run(M.RangeQuery(), rects, strict=True))
        check(f"strict {sel}")
    assert te._sticky[("range",)] != (2, 1)
    ix = np.random.default_rng(0).integers(0, len(x), 40)
    qx, qy, r = x[ix], y[ix], np.full(40, 0.01, np.float32)
    polys, ne = ds.random_polygons(6, part.bounds, seed=3)
    both(lambda e, M: e.run(M.Knn(k=5), qx, qy, strict=True))
    both(lambda e, M: e.run(M.CircleQuery(), qx, qy, r, strict=True))
    both(lambda e, M: e.run(M.SpatialJoin(), polys, ne, strict=True))
    check("strict families")
    both(lambda e, M: e.run(M.Knn(k=5), qx, qy))     # bucketed (40 rows)
    both(lambda e, M: e.run(M.CircleQuery(), qx, qy, r))
    assert te.probe_syncs == je.probe_syncs == 2
    both(lambda e, M: e.run(M.Knn(k=5), qx[:8], qy[:8]))   # narrow fused
    both(lambda e, M: e.run(M.SpatialJoin(), polys, ne))
    check("serving")
    hard = ds.random_rects(6, 0.3, part.bounds, seed=9, centers=(x, y))
    both(lambda e, M: e.run(M.RangeQuery(), hard))   # overflow, stashed
    moved = both(lambda e, M: e.maintain())          # sticky move
    assert moved[0] == moved[1] and ("range",) in moved[1]
    check("sticky move")
    both(lambda e, M: e.run(M.PointQuery(), x[:5], y[:5]))
    both(lambda e, M: e.run(M.RangeCount(), hard))
    both(lambda e, M: e.run(M.Knn(k=3, mode="exact"), x[:5], y[:5]))
    both(lambda e, M: e.run(M.SpatialJoin(mode="full"), polys, ne))
    check("exact families")
    n0 = te.stats()["cache_size"]
    for _ in range(2):                               # equal shapes
        both(lambda e, M: e.run(M.RangeCount(), hard))
        both(lambda e, M: e.run(M.Knn(k=5), qx[:8], qy[:8]))
    assert te.stats()["cache_size"] == n0
    both(lambda e, M: e.run(M.InsertBatch(), x[:20] + 1e-4, y[:20]))
    se = te.index.shape_epoch
    both(lambda e, M: e.run(M.InsertBatch(), x[20:40] + 1e-4, y[20:40]))
    check("inserts")
    assert te.index.shape_epoch == se                # equal-shape insert
    both(lambda e, M: e.run(M.InsertBatch(), x[:300] + 2e-4, y[:300]))
    assert te.index.shape_epoch > se                 # capacity growth
    assert all(k[5] == te.index.shape_epoch for k in te.cache_keys())
    check("capacity growth")
    both(lambda e, M: e.run(M.RangeCount(), hard))
    both(lambda e, M: e.run(M.DeleteBatch(), x[:20], y[:20]))
    both(lambda e, M: e.run(M.Refit()))
    check("delete and refit")


def test_manifest_matches_jax_under_the_key_dtype_mapping(taxi):
    x, y, part, jidx, tidx = taxi
    je = J.Executor(jidx, config=J.EngineConfig(delta_cap=64))
    te = T.Executor(tidx, T.EngineConfig(delta_cap=64), **CPU)
    for e, M in ((je, J), (te, T)):
        # the first insert installs the delta buffers (a shape epoch)
        e.run(M.InsertBatch(), x[:30] + 1e-4, y[:30])
        e.run(M.DeleteBatch(), x[:10], y[:10])
        settle_and_serve(e.run, e.maintain, _workload(x, y, part, M))
    jm = json.loads(json.dumps(je.manifest()))
    tm = json.loads(json.dumps(te.manifest()))
    # the documented mapping: backend xla -> torch; the index key's
    # dtype uint32 -> int64 (the update programs' delta_key and key)
    jm["backend"] = "torch"
    for p in jm["programs"]:
        p["key"][0] = "torch"
        for sig in p["sigs"]:
            for a in sig:
                if a[1] == "uint32":
                    a[1] = "int64"
    assert tm == jm
    assert {p["key"][3] for p in tm["programs"]} >= {"x", "fused", "u"}
    # and the mapping is the only difference: no uint32 in the port's
    assert all(a[1] != "uint32" for p in tm["programs"]
               for sig in p["sigs"] for a in sig)


# -- restart: a fresh process prewarmed from the manifest -----------------

_RESTART = """
import json, sys
import numpy as np
import torch
from test_torch_compile_cache import (_data, _leaves, _workload,
                                      sig_count)
from repro_torch import core as T
from repro_torch.core.compile_cache import load_manifest
from repro_torch.serve import SpatialServeSession

torch.set_num_threads(1)
man_path, out_npz = sys.argv[1:3]
x, y, part = _data()
sess = SpatialServeSession(T.build_index(x, y, part, device="cpu"),
                           device="cpu")
res = sess.prewarm(load_manifest(man_path), exercise=True)
st0, n0 = sess.stats(), sig_count(sess.executor)
out = {name: _leaves(sess.submit(spec, *args))
       for name, spec, args in _workload(x, y, part, T)}
np.savez(out_npz, **{f"{n}.{i}": lf for n, ls in out.items()
                     for i, lf in enumerate(ls)})
st = sess.stats()
print(json.dumps({"compiled": res["compiled"],
                  "new_programs": st["cache_size"] - st0["cache_size"],
                  "new_sigs": sig_count(sess.executor) - n0,
                  "host_syncs": st["host_syncs"] - st0["host_syncs"]}))
"""


def test_restart_bitwise_parity(tmp_path, built):
    """A restarted process prewarmed from the first one's manifest
    answers every family bitwise as the first process, and as the JAX
    Executor does on the same traffic, realizing nothing new."""
    x, y, part, index = built
    sess = TSession(index, **CPU)
    ref = settle_and_serve(sess.submit, sess.maintain,
                           _workload(x, y, part, T))
    jex = J.Executor(J.build_index(x, y, part))
    jref = settle_and_serve(jex.run, jex.maintain, _workload(x, y, part, J))
    for name, leaves in ref.items():
        for a, b in zip(jref[name], leaves, strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    man = tmp_path / "prewarm.json"
    save_manifest(man, sess.manifest())

    script = tmp_path / "restart.py"
    script.write_text(_RESTART)
    out_npz = tmp_path / "restart.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    proc = subprocess.run([sys.executable, str(script), str(man),
                           str(out_npz)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    st = json.loads(proc.stdout.strip().splitlines()[-1])
    assert st == {"compiled": sig_count(sess.executor), "new_programs": 0,
                  "new_sigs": 0, "host_syncs": 0}, st
    got = np.load(out_npz)
    for name, leaves in ref.items():
        for i, lf in enumerate(leaves):
            other = got[f"{name}.{i}"]
            assert lf.dtype == other.dtype and np.array_equal(lf, other), \
                f"{name} leaf {i} drifted across the restart"
