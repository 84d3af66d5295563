#!/usr/bin/env python3
"""Time this tree's interval-scan kernels (range_count, circle_count and
the join's point_in_polygon) against another tree's (a parent commit's),
in one process on one CUDA card.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/ab_parent.py build/parent

The other tree's csrc/range_filter.cu, csrc/circle_filter.cu and
csrc/point_in_polygon.cu are built from its own csrc directory beside
this tree's. Their launchers take the same arguments, so swapping the
loaded libraries under this tree's wrappers changes nothing else. On
chip_smoke.py's index and queries (taxi, 2^23 points, kdtree with 128
partitions; 32 polygons for the full join):

  - in turns (parent, change, change, parent): each kernel's device time
    per main-path call, per chunk and per call at the serving shape (the
    first 16 queries, or 4 polygons, of the same chunks), all from CUDA
    events with the stream held busy (chip_smoke.stream_ms), the host's
    time to enqueue a call's launches (chip_smoke.cuda_ms), and the
    device busy time (a profiler trace) of the 1,024-rect range count,
    of the exact circle program on 256 circles, of the full join of 32
    polygons and of a steady serving round at q = 16, which also runs
    once under torch.cuda.set_sync_debug_mode("error") with host_syncs
    held;
  - in PAIRS interleaved pairs, alternating which tree goes first: the
    wall time (median of a few synchronised calls) of the range count,
    the exact circle program, the full join, the serving round and its
    range-count, circle and join requests, and the host's time to
    enqueue one call's 17 launches of each kernel (no synchronise in the
    timed region); per metric, each tree's median and quartiles over the
    pairs and the pairs the change won.

Every turn's outputs must equal the first turn's bit for bit. Writes
chiprun_out/ab_parent.json and prints one line per turn and per metric.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)

SOURCES = ("range_filter", "circle_filter", "point_in_polygon")
ORDER = ("parent", "change", "change", "parent")
PAIRS = 20


def build_other(tree: Path) -> dict:
    """Build the other tree's sources, one nvcc each, all at once; load
    them with this tree's signatures (where the function exists)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import circle_filter as CF
    from repro_torch.kernels import point_in_polygon as PIP
    from repro_torch.kernels import range_filter as RF
    sigs = {"range_filter": RF._SIG, "circle_filter": CF._SIG,
            "point_in_polygon": PIP._SIG}
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
            if hasattr(lib, fn):
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
    from repro_torch import kernels as KERN
    from repro_torch.core import SpatialEngine
    from repro_torch.core import keys as K
    from repro_torch.kernels import _build
    from repro_torch.kernels import circle_filter as CF
    from repro_torch.kernels import point_in_polygon as PIP
    from repro_torch.kernels import range_filter as RF
    from repro_torch.serve import SpatialServeSession

    dev = torch.device(CS.DEVICE)
    card = CS.card_line()
    libs = {"parent": build_other(Path(sys.argv[1]).resolve()),
            "change": {n: _build.load(n, m._SIG)
                       for n, m in zip(SOURCES, (RF, CF, PIP))}}
    x, y, part, index, _, _ = CS.full_index(dev)
    (_, _, rects, _, _, _, cx, cy, cr, polys,
     ne) = CS.main_inputs(x, y, part)
    eng = SpatialEngine(index, device=dev)
    ex = eng.executor
    rect_t = torch.as_tensor(rects, device=dev)
    klo, khi = (K.keys_to_f32(v) for v in K.rect_key_range(rect_t, ex.spec))
    rc_args = CS.count_launch_args(ex, rect_t, klo, khi)
    crect, cklo, ckhi, ccirc = ex._circle_args((cx, cy, cr))
    cc_args = CS.count_launch_args(ex, crect, cklo, ckhi, ccirc)
    jc_args = CS.join_launch_args(ex, polys, ne)
    calls = {"range_count_1024": lambda: eng.range_count(rects),
             "circle_exact_256":
                 lambda: ex._circle_exact(ex._circle_args((cx, cy, cr))),
             "join_full_32": lambda: eng.join_count(polys, ne, mode="full")}
    sess = SpatialServeSession(index, device=dev)
    sess.warmup(CS.serve_round(x, y, part, 0, dev))
    reqs = CS.serve_round(x, y, part, 1, dev)
    # name -> (wrapper, main-path launches, serving-shape launches)
    kernels = {
        "range_count": (RF.range_count, rc_args,
                        [CS.first_queries(a, CS.SERVE_Q) for a in rc_args]),
        "circle_count": (CF.circle_count, cc_args,
                         [CS.first_queries(a, CS.SERVE_Q) for a in cc_args]),
        "join_count": (PIP.join_count, jc_args,
                       [CS.first_polygons(a, CS.SERVE_POLYGONS)
                        for a in jc_args])}

    def outputs():
        got = [fn() for fn in calls.values()]
        got += [fn(*a) for fn, args, narrow in kernels.values()
                for a in args + narrow]
        for o in sess.submit_batch(reqs):
            got += list(o) if isinstance(o, tuple) else [o]
        return got

    def use(tree):
        for name in SOURCES:
            _build._libs[name] = libs[tree][name]

    def round_():
        return sess.submit_batch(reqs)

    turns, first = [], None
    for tree in ORDER:
        use(tree)
        got = outputs()
        if first is None:
            first = got
        CS.require(all(torch.equal(a, b) for a, b in zip(got, first)),
                   f"{tree}: outputs differ from the first turn's")
        row = {"tree": tree}
        for kname, (fn, args, narrow) in kernels.items():
            def sweep(fn=fn, args=args):
                return [fn(*a) for a in args]
            row[kname] = {
                "ms_per_call": CS.stream_ms(sweep, 20),
                "enqueue_ms_per_call": CS.cuda_ms(sweep, 50),
                "ms_per_chunk": [CS.stream_ms(lambda fn=fn, a=a: fn(*a), 20)
                                 for a in args],
                "serve_shape_ms_per_call": CS.stream_ms(
                    lambda fn=fn, narrow=narrow: [fn(*a) for a in narrow],
                    20)}
        for cname, fn in calls.items():
            KERN.reset_launch_counts()
            fn()
            row[cname] = {"busy_ms": sum(CS.device_profile(fn, 3).values()),
                          "launches": {n: c for n, c in
                                       KERN.launch_counts().items() if c}}
        torch.cuda.synchronize()
        syncs = sess.stats()["host_syncs"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            round_()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        CS.require(sess.stats()["host_syncs"] == syncs,
                   f"{tree}: a steady serving round read the device")
        row["serve_round"] = {
            "busy_ms": sum(CS.device_profile(round_, 1).values()),
            "host_syncs_added": 0}
        turns.append(row)
        CS.log(f"[ab] {tree}: " + "; ".join(
            f"{k} {row[k]['ms_per_call']:.5f} ms/call (enqueue "
            f"{row[k]['enqueue_ms_per_call']:.5f}, serving shape "
            f"{row[k]['serve_shape_ms_per_call']:.5f})" for k in kernels)
            + "; busy " + ", ".join(
                f"{c} {row[c]['busy_ms']:.3f}"
                for c in (*calls, "serve_round")))

    def enqueue_ms(fn, reps):
        """Median host time to enqueue ``fn``'s launches (the device
        catches up outside the timed region)."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    # host times, in interleaved pairs: (timer, function, calls per
    # sample); walls end in a synchronise
    walls = {"range_count_1024": (CS.host_ms, calls["range_count_1024"], 9),
             "circle_exact_256": (CS.host_ms, calls["circle_exact_256"], 9),
             "join_full_32": (CS.host_ms, calls["join_full_32"], 9),
             "serve_round": (CS.host_ms, round_, 3),
             "serve_request_range_count":
                 (CS.host_ms, lambda: sess.submit(*reqs[1]), 5),
             "serve_request_circle_count":
                 (CS.host_ms, lambda: sess.submit(*reqs[3]), 3),
             "serve_request_join":
                 (CS.host_ms, lambda: sess.submit(*reqs[5]), 3),
             **{f"enqueue_{k}_17_launches":
                (enqueue_ms, lambda fn=fn, args=args: [fn(*a) for a in args],
                 21) for k, (fn, args, _) in kernels.items()}}
    samples = {w: {"parent": [], "change": []} for w in walls}
    for pair in range(PAIRS):
        for tree in (("parent", "change") if pair % 2 == 0
                     else ("change", "parent")):
            use(tree)
            for w, (timer, fn, reps) in walls.items():
                samples[w][tree].append(timer(fn, reps))
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
