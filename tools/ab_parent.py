#!/usr/bin/env python3
"""Time this tree's point query (the fused point kernel, one launch per
call) against another tree's (a parent commit's staged point program:
the candidate filter and learned lookup in PyTorch, then one point_probe
launch per candidate set), with this tree's range count and exact circle
program as controls, in one process on one CUDA card.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/ab_parent.py build/parent

The other tree must hold the staged point program (``core/local_ops.py``
``_PointLocal`` calling its backend's ``point_scan``), as commit
57320f9 does. Its ``core/queries.py``, ``core/backends.py``,
``core/local_ops.py`` and ``kernels/point_probe.py`` are loaded from its
files under other module names, and its ``csrc/point_probe.cu``,
``csrc/range_filter.cu`` and ``csrc/circle_filter.cu`` are built beside
this tree's. In the other tree's turns the executor runs the other
tree's ``_PointLocal`` on its backend and kernel; the range count and
the exact circle program run the other tree's two interval-scan
libraries under this tree's wrappers (the same code in 57320f9, so
their rows are the control). On chip_smoke.py's index and queries (taxi,
2^23 points, kdtree with 128 partitions; 1,024 point queries, half of
them data points):

  - in turns (parent, change, change, parent): the point call's kernel
    device time (the other tree's two launches, or this tree's one,
    from CUDA events with the stream held busy: chip_smoke.stream_ms)
    and the whole call's device time the same way; the device busy time
    (a profiler trace) of the point call, of the 1,024-rect range count,
    of the exact circle program on 256 circles, and of a steady serving
    round at q = 16, which also runs once under
    torch.cuda.set_sync_debug_mode("error") with host_syncs held; each
    call's launches;
  - in PAIRS interleaved pairs, alternating which tree goes first: the
    wall time (median of a few synchronised calls) of the point call,
    the range count, the exact circle program, the serving round and
    its point request; per metric, each tree's median and quartiles
    over the pairs and the pairs the change won.

Every turn's outputs must equal the first turn's bit for bit. Writes
chiprun_out/ab_parent.json and prints one line per turn and per metric.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)

SOURCES = ("range_filter", "circle_filter", "point_probe")
ORDER = ("parent", "change", "change", "parent")
PAIRS = 20


def load_other(tree: Path, rel: str, name: str):
    """The other tree's module ``src/repro_torch/<rel>``, loaded as
    ``name``; its own imports resolve to this tree's package."""
    spec = importlib.util.spec_from_file_location(
        name, tree / "src" / "repro_torch" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_other(tree: Path, sigs: dict) -> dict:
    """Build the other tree's sources, one nvcc each, all at once; load
    them with ``sigs`` ({source: {function: argtypes}})."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other tree's {name}:\n"
                               f"{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in sigs[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_parent: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import SpatialEngine
    from repro_torch.core import local_ops as L
    from repro_torch.kernels import _build
    from repro_torch.kernels import circle_filter as CF
    from repro_torch.kernels import point_probe as PP
    from repro_torch.kernels import range_filter as RF
    from repro_torch.serve import SpatialServeSession

    tree = Path(sys.argv[1]).resolve()
    # the other tree's point program: its queries, kernel wrapper,
    # backend and local program, each bound to the other's module
    o_pp = load_other(tree, "kernels/point_probe.py", "other_point_probe")
    o_q = load_other(tree, "core/queries.py", "other_queries")
    o_bk = load_other(tree, "core/backends.py", "other_backends")
    o_bk._pp = o_pp
    o_l = load_other(tree, "core/local_ops.py", "other_local_ops")
    o_l.Q = o_q

    class OtherPoint(o_l._PointLocal):
        """The other tree's _PointLocal on its cuda backend, built where
        the executor builds this tree's."""

        def __init__(self, index, cfg, backend):
            del backend
            super().__init__(index, cfg, o_bk.CudaBackend())

    dev = torch.device(CS.DEVICE)
    card = CS.card_line()
    libs = {"parent": build_other(tree, {"range_filter": RF._SIG,
                                         "circle_filter": CF._SIG,
                                         "point_probe": o_pp._SIG}),
            "change": {n: _build.load(n, m._SIG)
                       for n, m in zip(SOURCES, (RF, CF, PP))}}
    programs = {"parent": OtherPoint, "change": L._PointLocal}
    kernels = {"parent": o_pp, "change": PP}
    x, y, part, index, _, _ = CS.full_index(dev)
    qx, qy, rects, _, _, _, cx, cy, cr, _, _ = CS.main_inputs(x, y, part)
    eng = SpatialEngine(index, device=dev)
    ex = eng.executor
    qxt, qyt = (torch.as_tensor(a, device=dev) for a in (qx, qy))
    calls = {"point_1024": lambda: eng.point_query(qxt, qyt),
             "range_count_1024": lambda: eng.range_count(rects),
             "circle_exact_256":
                 lambda: ex._circle_exact(ex._circle_args((cx, cy, cr)))}
    sess = SpatialServeSession(index, device=dev)
    reqs = CS.serve_round(x, y, part, 1, dev)

    def use(tree_):
        for name in SOURCES:
            _build._libs[name] = libs[tree_][name]
        L._PointLocal = programs[tree_]

    # each tree's point-kernel launches of one point call, captured
    launch_args = {}
    for tree_, mod in kernels.items():
        use(tree_)
        name = "point_probe" if tree_ == "parent" else "point_query"
        wrapper, got = getattr(mod, name), []

        def capture(*a, _w=wrapper, _got=got, **kw):
            _got.append((a, kw))
            return _w(*a, **kw)

        setattr(mod, name, capture)
        calls["point_1024"]()
        setattr(mod, name, wrapper)
        launch_args[tree_] = (wrapper, got)
    use("parent")
    sess.warmup(CS.serve_round(x, y, part, 0, dev))

    def outputs():
        got = [fn() for fn in calls.values()]
        for o in sess.submit_batch(reqs):
            got += list(o) if isinstance(o, tuple) else [o]
        return got

    def round_():
        return sess.submit_batch(reqs)

    def point_kernels(tree_):
        wrapper, got = launch_args[tree_]
        return lambda: [wrapper(*a, **kw) for a, kw in got]

    turns, first = [], None
    for tree_ in ORDER:
        use(tree_)
        got = outputs()
        if first is None:
            first = got
        CS.require(all(torch.equal(a, b) for a, b in zip(got, first)),
                   f"{tree_}: outputs differ from the first turn's")
        row = {"tree": tree_,
               "point_kernel_ms_per_call": CS.stream_ms(point_kernels(tree_),
                                                        20),
               "point_kernel_launches_per_call": len(launch_args[tree_][1]),
               "point_call_device_ms": CS.stream_ms(calls["point_1024"], 20)}
        for cname, fn in calls.items():
            acts: dict = {}
            prof, kept = CS.traced(fn, 3, acts)
            row[cname] = {"busy_ms": sum(prof.values()),
                          "trace_retention": kept,
                          "activities_per_call": sum(acts.values())}
        torch.cuda.synchronize()
        syncs = sess.stats()["host_syncs"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            round_()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        CS.require(sess.stats()["host_syncs"] == syncs,
                   f"{tree_}: a steady serving round read the device")
        row["serve_round"] = {
            "busy_ms": sum(CS.device_profile(round_, 1).values()),
            "host_syncs_added": 0}
        turns.append(row)
        CS.log(f"[ab] {tree_}: point kernels "
               f"{row['point_kernel_ms_per_call']:.5f} ms/call "
               f"({row['point_kernel_launches_per_call']} launches), point "
               f"call device {row['point_call_device_ms']:.5f} ms; busy "
               + ", ".join(f"{c} {row[c]['busy_ms']:.3f} (activities "
                           f"{row[c].get('activities_per_call', 0):.1f})"
                           for c in (*calls, "serve_round")))

    # walls, in interleaved pairs: (function, calls per sample)
    walls = {"point_1024": (calls["point_1024"], 9),
             "range_count_1024": (calls["range_count_1024"], 9),
             "circle_exact_256": (calls["circle_exact_256"], 9),
             "serve_round": (round_, 3),
             "serve_request_point": (lambda: sess.submit(*reqs[0]), 9)}
    samples = {w: {"parent": [], "change": []} for w in walls}
    for pair in range(PAIRS):
        for tree_ in (("parent", "change") if pair % 2 == 0
                      else ("change", "parent")):
            use(tree_)
            for w, (fn, reps) in walls.items():
                samples[w][tree_].append(CS.host_ms(fn, reps))
    wall = {}
    for w, got in samples.items():
        q = {t: statistics.quantiles(v, n=4) for t, v in got.items()}
        won = sum(c < p for p, c in zip(got["parent"], got["change"]))
        wall[w] = {"samples": got, "change_won": won, "pairs": PAIRS,
                   **{f"{t}_median": statistics.median(v)
                      for t, v in got.items()},
                   **{f"{t}_quartiles": [q[t][0], q[t][2]] for t in q}}
        CS.log(f"[ab] wall {w}: parent median {wall[w]['parent_median']:.3f}"
               f" ms (quartiles {q['parent'][0]:.3f}-{q['parent'][2]:.3f}),"
               f" change {wall[w]['change_median']:.3f} ms (quartiles "
               f"{q['change'][0]:.3f}-{q['change'][2]:.3f}); change "
               f"faster in {won} of {PAIRS} pairs")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_parent.json").write_text(json.dumps(
        {"card": card, "order": ORDER, "turns": turns, "wall": wall},
        indent=1))
    CS.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
