"""The port's example twins (``examples/quickstart_torch.py`` and
``examples/spatial_analytics_torch.py``) run on the CPU in subprocesses
at 20,000 points and print, line for line, what the JAX package's own
``examples/quickstart.py`` and ``examples/spatial_analytics.py`` print
at that size (run beside them in subprocesses; only the timing, the
backend's name, its compile time and the port's one extra stats key
may differ); ``--dist`` at world size 2 (gloo, under
``torch.distributed.run``) prints the same lines. The serve_decode twin
(``examples/serve_decode_torch.py``) at float32 compute, on the weights
the reference's ``examples/serve_decode.py`` saved from its own run at
float32, prints the reference's first tokens. Every count the twins
print also equals the port's engine on the same inputs: those expected
lines (``quickstart_want``, ``analytics_want``) and their parsers are
shared with chip_smoke.py's examples phase, which runs the twins at
their defaults on the card, so this file imports neither jax nor repro
(the reference runs only in its subprocesses)."""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (CircleQuery, Executor, Knn, PointQuery,
                              RangeCount, SpatialJoin, build_index, fit)
from repro_torch.data import spatial as ds

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 20000


# examples/quickstart.py at sys.argv[1] points: it takes no --n, so its
# one call of ds.make gets the size
REF_QUICKSTART = (
    "import runpy, sys\n"
    "import repro.data.spatial as ds\n"
    "make, n = ds.make, int(sys.argv[1])\n"
    "ds.make = lambda kind, _n, *a, **kw: make(kind, n, *a, **kw)\n"
    "sys.argv = ['examples/quickstart.py']\n"
    "runpy.run_path('examples/quickstart.py', run_name='__main__')\n")


# examples/serve_decode.py's own functions, every arch's compute dtype
# replaced by sys.argv[2], each arch's weights (its model.init) saved
# under sys.argv[1]/<arch> for the twin's --params
REF_SERVE_DECODE = (
    "import dataclasses, importlib.util, sys\n"
    "from repro.checkpoint import save_checkpoint\n"
    "spec = importlib.util.spec_from_file_location(\n"
    "    'serve_decode', 'examples/serve_decode.py')\n"
    "mod = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(mod)\n"
    "out, dtype, arch = sys.argv[1], sys.argv[2], [None]\n"
    "get, build = mod.get_config, mod.build_model\n"
    "def get_config(a, smoke=False):\n"
    "    arch[0] = a\n"
    "    return dataclasses.replace(get(a, smoke=smoke),\n"
    "                               compute_dtype=dtype)\n"
    "def build_model(cfg):\n"
    "    model, name = build(cfg), arch[0]\n"
    "    init = model.init\n"
    "    def saved(rng):\n"
    "        params = init(rng)\n"
    "        save_checkpoint(f'{out}/{name}', 0, params)\n"
    "        return params\n"
    "    model.init = saved\n"
    "    return model\n"
    "mod.get_config, mod.build_model = get_config, build_model\n"
    "mod.main()\n")


def _start(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return out


def _run(args, timeout=300):
    return _finish(_start(args), timeout)


@pytest.fixture(scope="module")
def serve_params(tmp_path_factory):
    """Where the reference's serve_decode run saves its weights."""
    return str(tmp_path_factory.mktemp("serve_decode"))


@pytest.fixture(scope="module")
def background(serve_params):
    """The JAX package's three examples (two at ``N`` points, serve_decode
    at float32 compute) and the analytics twin's ``--dist`` run, started
    at once so they run while the twins do; {name: a function giving
    its stdout}."""
    procs = {"quickstart": _start(["-c", REF_QUICKSTART, str(N)]),
             "serve_decode": _start(["-c", REF_SERVE_DECODE, serve_params,
                                     "float32"]),
             "analytics": _start(["examples/spatial_analytics.py", "--n",
                                  str(N)]),
             "dist": _start(["-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", "2",
                             "examples/spatial_analytics_torch.py",
                             "--dist", "--device", "cpu", "--n", str(N)])}
    outs = {}

    def out(name):
        if name not in outs:
            outs[name] = _finish(procs[name], timeout=600)
        return outs[name]

    yield out
    for p in procs.values():
        p.kill()
        p.communicate()


# what may differ between the packages' printed stats: the backend's
# name, the reference's XLA compile time and the port's extra key
STATS_OWN = ("backend", "compile_ms_total", "async_capture_errors")


def comparable(out: str) -> list:
    """An example's lines as the two packages must agree on them: the
    join's milliseconds masked, the mesh's line dropped, the stats line
    parsed without ``STATS_OWN``."""
    lines = []
    for ln in out.splitlines():
        if ln.startswith("distributed over "):
            continue
        if ln.startswith("executor stats: "):
            stats = ast.literal_eval(ln.split(": ", 1)[1])
            lines.append({k: v for k, v in stats.items()
                          if k not in STATS_OWN})
            continue
        lines.append(re.sub(r": \d+ ms$", ": <ms> ms", ln))
    return lines


def _ints(line: str) -> list:
    """The integers of the numpy array printed after a line's label
    (``label: [ 1  2 ...]``)."""
    arr = line.split(": ", 1)[1]
    body = arr[arr.index("[") + 1:arr.rindex("]")]
    return [int(v) for v in body.split()]


def _line(out: str, prefix: str) -> str:
    (hit,) = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    return hit


def quickstart_want(n: int, device) -> dict:
    """What examples/quickstart_torch.py must print at ``n`` points,
    from the engine on ``device``: {label: integers}. The join counts
    are the full (exact) join's."""
    x, y = ds.make("taxi", n, seed=0)
    part = fit("kdtree", x, y, num_partitions=64)
    ex = Executor(build_index(x, y, part, device=device), device=device)
    rects = ds.random_rects(8, 1e-4, part.bounds, seed=1, centers=(x, y))
    r = np.full(4, 0.02, np.float32)
    _, ids = ex.run(Knn(k=5), x[:4], y[:4])
    polys, ne = ds.random_polygons(4, part.bounds, seed=2)
    return {
        "point query (known points):":
            ex.run(PointQuery(), x[:4], y[:4]).int().tolist(),
        "range counts:": ex.run(RangeCount(), rects).tolist(),
        "circle counts:":
            ex.run(CircleQuery(), x[:4], y[:4], r).tolist(),
        "knn ids[0]:": ids[0].tolist(),
        "join counts:":
            ex.run(SpatialJoin(mode="full"), polys, ne).tolist()}


def quickstart_got(out: str) -> dict:
    """The same labels' integers as quickstart_torch.py printed them."""
    got = {}
    for label in ("range counts:", "circle counts:", "knn ids[0]:",
                  "join counts:"):
        got[label] = _ints(_line(out, label))
    pq = _line(out, "point query (known points):")
    got["point query (known points):"] = [
        int(v == "True") for v in pq.split("[")[1].rstrip("]").split()]
    return got


def analytics_want(n: int, device) -> dict:
    """What examples/spatial_analytics_torch.py must print at ``n``
    points, from the engine on ``device``: the five densest zones as
    (zone, count) by the full join, and the exact 10-NN ids of the
    densest zone's centroid (the first five)."""
    x, y = ds.make("taxi", n, seed=7)
    part = fit("kdtree", x, y, 64, seed=0)
    ex = Executor(build_index(x, y, part, device=device), device=device)
    zones, ne = ds.random_polygons(32, part.bounds, seed=3, radius=0.05)
    full = ex.run(SpatialJoin(mode="full"), zones, ne).cpu().numpy()
    order = np.argsort(-full)
    cent = np.stack([zones[order[:5], :, 0].mean(axis=1),
                     zones[order[:5], :, 1].mean(axis=1)], axis=1)
    _, ids = ex.run(Knn(k=10, mode="exact"), cent[:, 0].astype(np.float32),
                    cent[:, 1].astype(np.float32))
    return {"zones": [(int(i), int(full[i])) for i in order[:5]],
            "nearest": ids[0, :5].tolist()}


def analytics_got(out: str) -> dict:
    return {"zones": [tuple(int(v) for v in re.findall(r"\d+", ln))
                      for ln in out.splitlines() if ln.startswith("  zone ")],
            "nearest": _ints(_line(out, "nearest shops"))}


@pytest.fixture(scope="module")
def quickstart(background):
    return _run(["examples/quickstart_torch.py", "--device", "cpu",
                 "--n", str(N)])


def test_quickstart_prints_the_reference_lines(quickstart, background):
    want = comparable(background("quickstart"))
    assert len(want) == 9 and want[0].startswith("index: 65 partitions")
    assert comparable(quickstart) == want


def test_quickstart_prints_the_engine_counts(quickstart):
    out = quickstart
    assert _line(out, "index: ").startswith("index: 65 partitions")
    want = quickstart_want(N, "cpu")
    assert want["point query (known points):"] == [1, 1, 1, 1]
    assert quickstart_got(out) == want
    stats = ast.literal_eval(_line(out, "executor stats:").split(": ", 1)[1])
    assert stats["backend"] == "torch" and stats["host_syncs"] >= 0


@pytest.fixture(scope="module")
def analytics(background):
    return _run(["examples/spatial_analytics_torch.py", "--device", "cpu",
                 "--n", str(N)])


def test_spatial_analytics_prints_the_reference_lines(analytics,
                                                      background):
    want = comparable(background("analytics"))
    assert len(want) == 9 and len(analytics_got(background("analytics"))[
        "zones"]) == 5
    assert comparable(analytics) == want


def test_spatial_analytics_prints_the_engine_join(analytics):
    got = analytics_got(analytics)
    assert len(got["zones"]) == 5
    assert got == analytics_want(N, "cpu")


def test_spatial_analytics_dist_matches_unmeshed(analytics, background):
    out = background("dist")
    assert "distributed over 2 devices" in out
    assert analytics_got(out) == analytics_got(analytics)
    assert comparable(out) == comparable(background("analytics"))
    assert out.count("commercial zones") == 1          # rank 0 prints


def first_tokens(out: str) -> dict:
    """{arch: its first tokens} of a serve_decode example's lines."""
    got = {}
    for ln in out.splitlines():
        if "first tokens: " in ln:
            got[ln.split()[0]] = ast.literal_eval(
                ln.split("first tokens: ", 1)[1])
    return got


def test_serve_decode_prints_the_reference_tokens(background,
                                                  serve_params):
    """The twin at float32 compute on the reference's weights (each
    arch's ``model.init(PRNGKey(0))``, read from the checkpoints the
    reference's run saved) prints the reference's first tokens."""
    want = first_tokens(background("serve_decode"))
    assert list(want) == ["qwen2.5-3b", "deepseek-v2-lite-16b", "rwkv6-3b",
                          "hymba-1.5b"]
    out = _run(["examples/serve_decode_torch.py", "--device", "cpu",
                "--compute-dtype", "float32", "--params", serve_params])
    assert first_tokens(out) == want
