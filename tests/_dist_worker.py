"""One rank of the port's meshed executor on the CPU (gloo), or the JAX
reference at the same mesh on fake CPU devices: the multi-process half
of tests/test_torch_dist.py, test_torch_query_shard.py and
test_torch_updates.py.

    python tests/_dist_worker.py --side port --scenario queries \
        --mesh 4 --rank R --world 4 --init file:///tmp/x/store --out DIR
    python tests/_dist_worker.py --side ref --scenario qshard+updates \
        --mesh 2x2dq --out DIR

``--scenario`` names one scenario or several joined by ``+``, run in
that order in one process (one process group). ``spawn`` gives the
reference side a process per scenario: they share no collective, so
they run side by side.
Each run writes ``DIR/<side>_<scenario>_<mesh>[_r<rank>].npz``: for every
call of the scenarios its outputs ``<name>/<i>`` as numpy arrays, or
``<name>/raised`` with the exception's text where the call raised. The
port side imports neither jax nor ``repro``; the reference side needs
XLA_FLAGS=--xla_force_host_platform_device_count=4 in its environment
(the test sets it).
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
from functools import partial

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

# mesh name -> (shape, axis names, part_axis, query_axis)
MESHES = {
    "4": ((4,), ("data",), "data", None),
    "2x2pd": ((2, 2), ("pod", "data"), ("pod", "data"), None),
    "2x2dq": ((2, 2), ("data", "query"), "data", "query"),
}
QSHARD_THRESHOLD = 16
N = 8000
K = 7
WORLD = 4
# the read calls of ``query_calls``, by name
FAMILIES = ("point", "range_count", "range_query", "circle_count",
            "circle_query", "knn", "knn_exact", "join", "join_full")
SERVING = ("range_query", "circle_count", "circle_query", "knn", "join")
STRICT = tuple(f"{n}/strict" for n in FAMILIES)
CALLS = STRICT + tuple(f"{n}/serving" for n in SERVING)
# the serving families that run a wide batch (40 rows: the bucketed
# dispatch with its need probes) on each mesh; the others run a narrow
# one (16 rows: one fused program per family). One family of each need
# probe, the window's and kNN's, each on one of the partition meshes:
# the wide batches are the costliest calls of both sides.
WIDE = {"4": ("range_query",), "2x2pd": ("knn",), "2x2dq": ()}


def serve_rows(mesh: str, family: str) -> int:
    """The rows of ``family``'s serving call on ``mesh``."""
    return 40 if family in WIDE[mesh] else 16
# the padded calls the reference makes: each raises at its un-pad
REF_PADDED = ("pad_point/strict", "pad_join/strict")
# the padded serving calls' rows: odd, at or above the query-shard
# threshold, narrow
PAD_SERVE = 17
# the families of the reference's query-shard and sharded-update tests
# (tests/test_query_shard.py, test_updates.py): the merges of the others
# are held at the (4,) and (2, 2) partition meshes
QSHARD_FAMILIES = ("point", "range_count", "range_query", "knn", "join")
UPDATE_FAMILIES = ("point", "range_count", "range_query", "knn")
# the ("data", "query") mesh's scenarios, one spawn for the two test
# files that read them (test_torch_query_shard.py, test_torch_updates.py)
MESH_2X2DQ = "qshard+updates"


def spawn(scenario: str, meshes, out_dir: str, timeout: float = 420.0):
    """Start every mesh's WORLD port ranks (gloo, a file store in
    ``out_dir``: no TCP port), which run the ``+``-joined scenarios in
    turn, and a reference process per scenario, all at once.
    Returns them as a ``Spawned``: calling it waits for them all and
    returns {mesh: (ref outputs, [rank outputs])}; a process that fails
    or outlives ``timeout`` fails the wait with its output."""
    import subprocess
    import time
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    me = os.path.abspath(__file__)
    procs = []
    for mesh in meshes:
        base = [sys.executable, me, "--scenario", scenario, "--mesh", mesh,
                "--out", out_dir]
        for r in range(WORLD):
            procs.append(subprocess.Popen(
                base + ["--side", "port", "--rank", str(r), "--world",
                        str(WORLD), "--init",
                        f"file://{out_dir}/store_{scenario}_{mesh}"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for part in scenario.split("+"):
            procs.append(subprocess.Popen(
                [sys.executable, me, "--scenario", part, "--mesh", mesh,
                 "--out", out_dir, "--side", "ref"],
                env=dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
                    f"--xla_force_host_platform_device_count={WORLD}")),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return Spawned(procs, time.monotonic() + timeout,
                   lambda: _load(scenario, meshes, out_dir))


class Spawned:
    """The processes of one ``spawn``: call it to wait for their results;
    ``close()`` stops whichever still run (a test module's teardown, where
    it never waited)."""

    def __init__(self, procs, deadline, load):
        self.procs, self.deadline, self.load = procs, deadline, load

    def __call__(self):
        import subprocess
        import time
        failed = []
        try:
            for p in self.procs:
                try:
                    log, _ = p.communicate(
                        timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append(f"{p.args}: timed out")
                    continue
                if p.returncode:
                    failed.append(f"{p.args}: exit {p.returncode}\n"
                                  f"{log[-3000:]}")
        finally:
            self.close()
        if failed:
            raise RuntimeError("\n".join(failed))
        return self.load()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _load(scenario, meshes, out_dir):
    res = {}
    for mesh in meshes:
        ref = {}
        for part in scenario.split("+"):
            ref.update(np.load(os.path.join(out_dir,
                                            f"ref_{part}_{mesh}.npz")))
        ranks = [dict(np.load(os.path.join(
            out_dir, f"port_{scenario}_{mesh}_r{r}.npz")))
            for r in range(WORLD)]
        res[mesh] = (ref, ranks)
    return res


def spawn_once(scenario: str, meshes, tmp_path_factory,
               timeout: float = 420.0):
    """``spawn``, once per pytest session: the first test module to ask
    (in whichever xdist worker) starts the processes, and every other one
    waits for the same results, so two test files that hold one mesh's
    scenarios share its ranks and reference processes. Returns a wait
    function like ``spawn``'s; a failed spawn fails every wait."""
    import fcntl
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent              # the session's, not the worker's
    out = root / f"spawn_{scenario}_{'_'.join(meshes)}"
    fh = open(f"{out}.lock", "w")

    def result():
        with fh:
            if (out / "failed").exists():
                raise RuntimeError((out / "failed").read_text())
            if not (out / "done").exists():
                raise RuntimeError(f"{out}: no results")
            return _load(scenario, meshes, str(out))

    try:
        fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:             # another worker is spawning
        def wait_other():
            fcntl.flock(fh, fcntl.LOCK_EX)
            return result()
        return wait_other
    if (out / "done").exists() or (out / "failed").exists():
        return result
    out.mkdir(exist_ok=True)
    wait = spawn(scenario, meshes, str(out), timeout)

    def wait_mine():
        try:
            wait()
        except Exception as e:
            (out / "failed").write_text(str(e))
            fh.close()
            raise
        (out / "done").write_text("")
        return result()
    return wait_mine


def outputs(d: dict, name: str):
    """The outputs of call ``name`` in a worker's results: a tuple of
    arrays, or None where the call raised."""
    if name + "/raised" in d:
        return None
    out, i = [], 0
    while f"{name}/{i}" in d:
        out.append(d[f"{name}/{i}"])
        i += 1
    assert out, name
    return tuple(out)


def same(a, b) -> bool:
    """Bitwise equality of two output tuples (dtypes and shapes too)."""
    return len(a) == len(b) and all(
        u.dtype == v.dtype and u.shape == v.shape and
        u.tobytes() == v.tobytes() for u, v in zip(a, b))


def compaction_same(a, b) -> bool:
    """DESIGN.md §10's rule for results of different layouts: counts,
    flags and kNN distances bitwise; materialized ids equal as sets
    where ok; kNN ids equal up to the order of equal distances."""
    if same(a, b):
        return True
    if len(a) != len(b):
        return False
    if len(a) == 3:                         # (counts, vids, ok)
        if not (same(a[:1], b[:1]) and same(a[2:], b[2:])):
            return False
        return all(set(u[u >= 0].tolist()) == set(v[v >= 0].tolist())
                   for u, v, ok in zip(a[1], b[1], a[2]) if ok)
    if len(a) == 2 and a[0].dtype == np.float32:          # kNN
        if not same(a[:1], b[:1]):
            return False
        key = [np.sort(v[1].astype(np.int64) + (v[0].view(np.int32)
                                                .astype(np.int64) << 32), 1)
               for v in (a, b)]
        return np.array_equal(*key)
    return False


def scenario_data(ds, fit):
    """The shared inputs: taxi points, a kdtree of 8 boxes, 42 query
    rows and 20 polygons. The calls take 40 rows and 20 polygons (a
    multiple of the 2-way query axis), and for padding 41 and 19."""
    x, y = ds.make("taxi", N, seed=2)
    part = fit("kdtree", x, y, 8)
    rng = np.random.default_rng(0)
    ix = rng.integers(0, len(x), 42)
    qx, qy = x[ix], y[ix]
    qx[-4:] = rng.random(4).astype(np.float32)       # some misses
    qy[-4:] = rng.random(4).astype(np.float32)
    rects = ds.random_rects(42, 1e-3, part.bounds, seed=3, centers=(x, y))
    r = np.full(42, 0.01, np.float32)
    polys, ne = ds.random_polygons(20, part.bounds, seed=5)
    return x, y, part, qx, qy, rects, r, polys, ne


def query_calls(T, qx, qy, rects, r, polys, ne, n=40, pg=20, tag="",
                serve_n=None, only=FAMILIES):
    """(name, spec, args, strict) of the read families ``only`` at ``n``
    rows and ``pg`` polygons, strict first (the adaptive ones settle
    their sticky tiers), then serving at ``serve_n`` rows: a number (the
    default ``n``; 0: no serving call) or a function of the family's
    name (from 32 rows a wide serving batch, the bucketed dispatch with
    its need probes)."""
    def families(m):
        q = (qx[:m], qy[:m])
        return {
            "point": (T.PointQuery(), q),
            "range_count": (T.RangeCount(), (rects[:m],)),
            "range_query": (T.RangeQuery(), (rects[:m],)),
            "circle_count": (T.CircleQuery(), q + (r[:m],)),
            "circle_query": (T.CircleQuery(materialize=True), q + (r[:m],)),
            "knn": (T.Knn(k=K), q),
            "knn_exact": (T.Knn(k=K, mode="exact"), q),
            "join": (T.SpatialJoin(), (polys[:pg], ne[:pg])),
            "join_full": (T.SpatialJoin(mode="full"), (polys[:pg], ne[:pg])),
        }

    out = [(tag + name + "/strict", *call, True)
           for name, call in families(n).items() if name in only]
    rows = serve_n if callable(serve_n) else (
        lambda _, m=n if serve_n is None else serve_n: m)
    out += [(tag + name + "/serving", *families(rows(name))[name], False)
            for name in SERVING if name in only and rows(name)]
    return out


def run_calls(ex, calls, out: dict, to_np) -> None:
    for name, spec, args, strict in calls:
        try:
            res = ex.run(spec, *args, strict=strict)
        except Exception as e:          # the reference raises on some
            out[name + "/raised"] = np.asarray(f"{type(e).__name__}: {e}")
            continue
        res = res if isinstance(res, tuple) else (res,)
        for i, a in enumerate(res):
            out[f"{name}/{i}"] = to_np(a)


def stats_of(ex, out: dict, tag: str) -> None:
    st = ex.stats()
    for k in ("epoch", "shape_epoch", "host_syncs", "qshard_executables",
              "updates", "refits"):
        out[f"{tag}stats/{k}"] = np.asarray(st[k])
    out[f"{tag}stats/delta_cap"] = np.asarray(int(ex.index.delta_cap or 0))
    out[f"{tag}stats/n_pad"] = np.asarray(int(ex.index.n_pad))
    out[f"{tag}stats/next_vid"] = np.asarray(int(ex.next_vid))
    out[f"{tag}stats/pending_refit"] = np.asarray(st["pending_refit"],
                                                  np.int64)


def point_two_index(build, x, y, part):
    """An index where point ``q`` is held by two partitions: built with
    ``q`` outside every grid box (so in the overflow grid), and grid box
    0's bounds widened to hold ``q`` (the caller inserts ``q`` there, into
    its delta buffer). Returns (index, widened boxes, q)."""
    b = part.bounds
    q = np.asarray([b[2] + 0.05, b[3] + 0.05], np.float32)
    x2 = np.append(x, q[0]).astype(np.float32)
    y2 = np.append(y, q[1]).astype(np.float32)
    idx = build(x2, y2, part)
    pb = np.array(idx.part_bounds)
    pb[0, 2], pb[0, 3] = q[0] + 0.01, q[1] + 0.01
    return idx, pb, q


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["port", "ref"], required=True)
    ap.add_argument("--scenario", required=True,
                    help="queries, qshard or updates, or several joined "
                    "by +")
    ap.add_argument("--mesh", choices=list(MESHES), required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if not set(a.scenario.split("+")) <= {"queries", "qshard", "updates"}:
        ap.error(f"unknown scenario in {a.scenario}")
    shape, names, paxis, qaxis = MESHES[a.mesh]
    out = {}
    if a.side == "port":
        # the reference process is the longest of a spawn: its ranks yield
        # the CPU to it
        os.nice(10)
        import torch
        torch.set_num_threads(1)
        from repro_torch import core as T
        from repro_torch.core import build_index, fit
        from repro_torch.data import spatial as ds
        from repro_torch.launch import mesh as M
        dev = M.init_process("cpu", init_method=a.init, world_size=a.world,
                             rank=a.rank,
                             timeout=datetime.timedelta(seconds=240))
        mesh = M.make_host_mesh(shape, names, device=dev)

        def make(idx, cfg):
            return T.Executor(idx, cfg, device="cpu", mesh=mesh,
                              part_axis=paxis, query_axis=qaxis)

        def build(xx, yy, pp):
            return build_index(xx, yy, pp, device="cpu")

        def to_np(t):
            return t.numpy() if hasattr(t, "numpy") else np.asarray(t)

        def with_bounds(idx, pb):
            import dataclasses
            return dataclasses.replace(idx, part_bounds=torch.as_tensor(pb))

        def as_f32(v):
            return torch.as_tensor(v, dtype=torch.float32)

        def query_keys(ex, px, py):
            return T.keys.keys_to_f32(T.keys.make_keys(px, py, ex.spec))
        fname = f"port_{a.scenario}_{a.mesh}_r{a.rank}.npz"
    else:
        import jax
        import jax.numpy as jnp
        from repro import core as T
        from repro.core import build_index, fit
        from repro.data import spatial as ds
        mesh = jax.make_mesh(shape, names)

        def make(idx, cfg):
            return T.Executor(idx, mesh=mesh, part_axis=paxis,
                              query_axis=qaxis, config=cfg)

        def build(xx, yy, pp):
            return build_index(xx, yy, pp)

        def to_np(t):
            return np.asarray(t)

        def with_bounds(idx, pb):
            import dataclasses
            return dataclasses.replace(idx, part_bounds=jnp.asarray(pb))

        def as_f32(v):
            return jnp.asarray(v, jnp.float32)

        def query_keys(ex, px, py):
            return ex._qkeys(px, py)
        fname = f"ref_{a.scenario}_{a.mesh}.npz"

    x, y, part, qx, qy, rects, r, polys, ne = scenario_data(ds, fit)
    cfg = T.EngineConfig(query_shard_threshold=QSHARD_THRESHOLD)
    idx = build(x, y, part)
    for sc in a.scenario.split("+"):
        if sc == "queries":
            ex = make(idx, cfg)
            run_calls(ex, query_calls(T, qx, qy, rects, r, polys, ne,
                                      serve_n=partial(serve_rows, a.mesh)),
                      out, to_np)
            stats_of(ex, out, "")
            if a.side == "port":       # the two refusals at world size > 1
                from repro_torch.serve.scheduler import SpatialScheduler
                for what, fn in (("precompiler", ex.start_precompiler),
                                 ("scheduler", lambda: SpatialScheduler(
                                     ex, start=False))):
                    try:
                        fn()
                        out[f"refuse/{what}"] = np.asarray("")
                    except ValueError as e:
                        out[f"refuse/{what}"] = np.asarray(str(e))
            if a.mesh == "4":
                # a point held in its grid box and in the overflow grid
                idx2, pb, q = point_two_index(build, x, y, part)
                ex2 = make(with_bounds(idx2, pb), cfg)
                ex2.run(T.InsertBatch(), q[:1], q[1:])
                px = np.append(qx[:7], q[0]).astype(np.float32)
                py = np.append(qy[:7], q[1]).astype(np.float32)
                run_calls(ex2, [("point2/strict", T.PointQuery(), (px, py),
                                 True)], out, to_np)
                # the merged flags under PointQuery's > 0, from its program
                px, py = as_f32(px), as_f32(py)
                fn = ex2._cache[ex2._key(("point",))]
                out["point2/sums"] = to_np(ex2._call(fn, px, py, query_keys(
                    ex2, px, py)))
        elif sc == "qshard":
            ex = make(idx, cfg)
            # unpadded (40 rows, 20 polygons; serving at 16), then padded
            # (41, 19; serving at 17)
            run_calls(ex, query_calls(T, qx, qy, rects, r, polys, ne,
                                      serve_n=16,
                                      only=QSHARD_FAMILIES), out, to_np)
            padded = query_calls(T, qx, qy, rects, r, polys, ne, n=41, pg=19,
                                 tag="pad_", serve_n=PAD_SERVE,
                                 only=QSHARD_FAMILIES)
            if a.side == "ref":
                padded = [c for c in padded if c[0] in REF_PADDED]
            run_calls(ex, padded, out, to_np)
            keys = ex.cache_keys()
            out["keys/qshard"] = np.asarray(sorted(repr(k[2:4]) for k in keys
                                                   if k[1]))
            out["keys/plain"] = np.asarray(sorted(repr(k[2:4]) for k in keys
                                                  if not k[1]))
            # below the threshold: the unsharded wrapping
            run_calls(ex, [("below/point", T.PointQuery(), (qx[:8], qy[:8]),
                            True)], out, to_np)
            out["keys/below_point"] = np.asarray(sum(
                1 for k in ex.cache_keys() if not k[1] and k[2] == ("point",)))
            # the fused serving path makes no host sync
            h = ex.host_syncs
            run_calls(ex, [("fused/range_query", T.RangeQuery(), (rects[:16],),
                            False)], out, to_np)
            out["fused/host_syncs"] = np.asarray(ex.host_syncs - h)
            stats_of(ex, out, "")
            if a.side == "port":
                # the manifest's query-sharded programs realized in a second
                # executor, and its families exercised (the reference skips
                # its query-sharded wrappings there)
                ex3 = make(idx, cfg)
                got = ex3.prewarm(ex.manifest(), exercise=True)
                for k, v in got.items():
                    out[f"prewarm/{k}"] = np.asarray(v)
                out["prewarm/qshard_keys"] = np.asarray(sorted(
                    repr(k[2:5]) for k in ex3.cache_keys() if k[1]))
                out["keys/qshard_full"] = np.asarray(sorted(
                    repr(k[2:5]) for k in ex.cache_keys() if k[1]))
        else:       # updates: inserts with a capacity growth, deletes, re-fit
            bx, by = ds.make("taxi", 400, seed=9)
            # 600 copies of one point: one shard's partition outgrows the
            # delta capacity, then n_pad and the probe at the re-fit
            bx = np.append(bx, np.full(600, x[500], np.float32))
            by = np.append(by, np.full(600, y[500], np.float32))
            if a.side == "ref":
                # the unsharded reference's statics after the same sequence
                plain = T.Executor(idx, config=cfg)
                plain.run(T.InsertBatch(), bx[:40], by[:40])
                stats_of(plain, out, "plain_ins0_")
                plain.run(T.InsertBatch(), bx[40:], by[40:])
                stats_of(plain, out, "plain_ins_")
                plain.run(T.DeleteBatch(), np.append(x[:100], bx[:20]),
                          np.append(y[:100], by[:20]))
                stats_of(plain, out, "plain_del_")
                plain.refit()
                stats_of(plain, out, "plain_refit_")
            ex = make(idx, cfg)
            out["vids0"] = to_np(ex.run(T.InsertBatch(), bx[:40], by[:40]))
            stats_of(ex, out, "ins0_")
            # past the first capacity: a growth, a shape-epoch bump
            out["vids"] = to_np(ex.run(T.InsertBatch(), bx[40:], by[40:]))
            stats_of(ex, out, "ins_")
            out["removed"] = np.asarray(ex.run(T.DeleteBatch(),
                                               np.append(x[:100], bx[:20]),
                                               np.append(y[:100], by[:20])))
            stats_of(ex, out, "del_")
            calls = query_calls(T, qx, qy, rects, r, polys, ne, serve_n=0,
                                only=UPDATE_FAMILIES)
            run_calls(ex, [(f"pre/{n}", s, g, st) for n, s, g, st in calls],
                      out, to_np)
            out["refit"] = np.asarray(ex.refit(), np.int64)
            stats_of(ex, out, "refit_")
            run_calls(ex, [(f"post/{n}", s, g, st) for n, s, g, st in calls],
                      out, to_np)
    np.savez(os.path.join(a.out, fname), **out)
    if a.side == "port":
        import torch.distributed as dist
        dist.barrier()              # every rank done before teardown
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
