#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and
check it. Run from the repository root, on a machine with a card and
the CUDA toolkit:

    python3 chip_smoke.py

Every executor here realizes its query programs as CUDA graphs (the
program cache, DESIGN.md §14): a program's first call at an argument
signature runs eagerly, its second captures its graph and replays it,
later calls replay it. A wrapper counts a launch where it launches its kernel; a replay
adds the launches its capture recorded (launches per capture x
replays), so the launch counts below count the kernels that replays
run. An engine built with ``cuda_graphs`` off runs every program
eagerly (the timings beside the graphs').

Phases (any failure raises, and the script exits non-zero without a
result line):

  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel of the main path from src/repro_torch/kernels/
              csrc, and the empty kernel of csrc/launch_floor.cu, one nvcc
              per source, all at once;
  3. golden   all 11 keys of tests/golden/spatial_golden.json replayed
              bitwise with backend="cuda" on the golden inputs rebuilt by
              the port, in tests/golden/gen_golden.py's order on one
              engine (the strict loop starts from earlier sticky tiers);
  4. build    the full-size index on the card: taxi, 2^23 points, seed 0,
              kdtree with 128 partitions;
  5. main     the main path once through SpatialEngine: 1,024 point
              queries, 1,024 range counts at selectivity 1e-5, 256 exact
              10-NN queries; then, with the traffic of
              src/repro/launch/spatial.py (256 queries), range_query on
              rects at selectivity 1e-5, circle_count and circle_query on
              circles of r = 0.01 centred on data points, the executor's
              exact circle program (the strict loop's fallback, which the
              ladder does not reach) on the same circles, pruned 10-NN,
              and join_count windowed and full on 32 random polygons.
              Every launch count is set to 0 just before and read just
              after, with each path's own launches (a point call must
              launch the fused point kernel once and nothing else);
              results held bitwise
              against the plain-PyTorch backend on the card, against each
              other (join windowed == full, pruned d2 == exact d2, circle
              counts == the exact program's) and against a numpy brute
              force (64 queries of each exact kind; every range query
              whose ok is true); per call the tier the strict loop settled
              on, peak device memory, batch latency, and the device's
              busy time, idle share and top activities from a profiler
              trace; then circle_count at its sticky tier under the
              default row-chunk budget (EngineConfig.scan_chunk_elems)
              and under twice it (on eager engines): rows per call, peak
              memory, latency. Each call's first result (its programs
              run eagerly) is held bitwise against a second and a third
              call (captures, then graph replays), and each call is
              timed again on an eager engine (wall and busy);
  6. serve    serving mode on the same index: a SpatialServeSession with
              the default config serving src/repro/launch/serve.py's
              mixed round at q = 16 (point, range count, range query at
              selectivity 1e-5, circle r = 0.02, 10-NN, a join of 4
              polygons); warmup on round 0, then 4 steady rounds with
              maintain() after each. Each steady round runs with its
              inputs on the card under
              torch.cuda.set_sync_debug_mode("error"), must leave
              host_syncs where it was, launch the fallback kernels (and
              the point kernel exactly once), and equal bitwise the same
              rounds on a backend="torch" session;
              counts are held against the exact programs and kNN
              distances against exact kNN. Per round: wall ms, launches,
              what maintain() moved, peak memory; once, a profiler trace
              of a steady round (device busy, idle share, top activities,
              the fallback programs' share), each request's latency, and
              pruned kNN's fixed-round cost against its early exit; no
              round makes a bucketing probe (probe_syncs stays 0); the
              same round and requests on a session running eagerly
              (bitwise equal; wall and busy beside the graphs'); last,
              a new session warmed on the round's range query, with its
              precompile worker: two escalations of the range family
              through maintain(), forced by whole-domain rectangles;
              after the first, the worker must have captured the tier
              above the new sticky one at the round's signature before
              any request needs it; the second makes it sticky, and the
              range query then replays that graph (no capture on the
              serving thread; counts equal the torch backend's);
  7. warm     warm start (DESIGN.md §14): (a) each of the seven
              launchers captured alone into a one-launch CUDA graph at
              the main path's shapes (tests/test_torch_gpu.py
              capture_alone), two replays bitwise its eager launch;
              (b) phase 5's per-family check (eager first call, graph
              replays, torch backend) and its graph and eager times, gathered;
              (c) two graphs of one executor's pool replayed in the
              reverse of their capture order (range count then point,
              three new inputs each), bitwise an eager engine; (d) is
              phase 9's: graphs captured after the inserts replay after
              the delete and the re-fit on planes written in place; (e)
              is phases 6 and 8: q = 16 and q = 64 rounds through graphs;
              (f) the kernel libraries kept in an on-disk store
              (EngineConfig.compile_cache_dir under build/), the serve
              session's manifest() saved, and a restart in a
              subprocess (``chip_smoke.py --restart``): the 2^23 index
              rebuilt from its seeds, a cold
              session's first call per family (the libraries from the
              store: one hit each, no nvcc), then prewarm(manifest,
              exercise=True) (prewarm_ms), the first call per family
              and the steady calls; every output bitwise the parent's,
              no program realized by the prewarmed traffic;
  8. wide     serving mode at src/repro/launch/serve.py's default q = 64
              (at or above tier_bucket_min = 32): a new session warmed on
              its round 0, then 3 steady rounds, where the range query,
              circle and kNN requests (64 rows; the join's 8 polygons
              are narrow) take the tier-bucketed dispatch. Each round
              runs under torch.cuda.set_sync_debug_mode("warn") with the
              warnings recorded: host_syncs stays where it was,
              probe_syncs grows by one per bucketed request, and the
              sync warnings equal that growth (the one host read of the
              bucket sizes per bucketed call); every output equals the
              torch backend's rounds bitwise and the exact programs'
              answers. Per round: wall ms per round and per request,
              each fused call's (family, tier, rows padded to a power of
              two), launches, peak memory; then each request's latency;
  9. updates  the update path on the same index through the engine
              (EngineConfig defaults): 8,192 inserts from the taxi
              generator (seed 1) and the two denormal points (1e-45, 0.5)
              and (-1e-45, 0.25); one delete batch of 3,072 originals,
              1,024 still-buffered inserts and (0.0, 0.25) (which removes
              the buffered (-1e-45, 0.25): a delete reads denormals as
              zero); then every call of phase 5 on the mutated index
              (the strict loop starting from phase 5's tiers; the
              graphs captured by two passes after the inserts, so these
              calls replay them after the delete), launch counts set
              to 0 just before and read just after (every query kernel
              must launch), each bitwise the torch backend on the card
              (run eagerly); the six query kernels against their plain
              versions at the main path's shapes on the mutated planes
              (tombstones inside count); Refit(), every call again and
              the kernels again on the re-fit index; a fresh build_index
              of the surviving points (vid=, n_pad= the re-fit index's):
              its data planes equal the re-fit ones, and every call
              before and after the re-fit equals it (counts, kNN d2 and
              id order bitwise, materialized ids as sets; kNN rows
              differing only in tie order before the re-fit are
              counted); then a delete at (0.0, 0.5) removes the merged
              (1e-45, 0.5) from the main plane. Insert, delete and re-fit
              ms, partitions touched, delta_cap, each call's ms before
              and after the re-fit beside the frozen index's, the calls'
              peak memory. Then a serving session (q = 16,
              delta_occupancy 1e-4, phase 6's tiers) warmed on a round,
              an insert of 1,024 points, two steady rounds under
              sync-debug "error" (host_syncs +0, every query kernel
              launched, outputs held against the exact programs),
              maintain() between them running the re-fit the insert
              scheduled (pending_refit empties);
 10. scheduler the streaming serve scheduler (serve/scheduler.py) on a
              new SpatialServeSession with the default config over the
              same index, serving src/repro/launch/serve.py --spatial
              --scheduler's traffic at --batch 64 --rounds 8: 512
              single-query requests, point, range count (selectivity
              1e-5), 10-NN and circle (r = 0.02) round-robin, numpy
              inputs as the launcher sends them; warmup on the first
              four. A serial replay through session.submit (all 512,
              or the first 64 of each kind when the whole would pass
              60 s); (a) drain mode: all 512 submitted, then drain():
              four coalesced batches of 128 (one per spec; 10-NN and
              circle bucketed), every ticket bitwise its serial result,
              probe_syncs and host_syncs deltas (the dispatches read no
              ok flag: host_syncs grows only by idle maintain()'s
              reads); (b) worker mode, 8 closed-loop client threads:
              every ticket bitwise serial, host_syncs as in (a), wall,
              req/s, p50/p99/max per request, mean and max batch, run
              twice: with the precompile worker (the default config:
              new batch widths and the tiers next to a sticky one are
              captured on the worker, which also ran through the
              session's serial replay and drain, started by hand; a
              batch pads to a larger captured width, or runs as a few
              replays of a smaller one, meanwhile), and on a session
              with serve_async_precompile=False given the same history
              (warmup, two serial submits of each kind, drain; every
              capture on the serving thread);
              per run width_fallbacks, async_compiles, the worker's
              capture failures (must be 0), the graphs and their pool's
              bytes, and the capture ms on each thread (the serving
              thread's must be 0 with the worker); (c) the same, with
              the worker, with the launcher's two InsertBatch requests
              of 64 points (one before the clients, one beside them):
              every read submitted after an insert resolved carries an
              epoch at or above it, maintain_busy 0, write_merges,
              maintain runs; peak memory of the phase. Launch counts are set to
              0 before each scheduler run and read after it (the serial
              replay is not counted);
 11. mesh     the multi-GPU path at world size 1: a one-rank NCCL
              process group in this process (a file store in a temporary
              directory), and over the same index a meshed SpatialEngine
              (a (1,) "data" mesh, the partitions on its part axis) and a
              (1, 1) ("data", "query") one whose query_shard_threshold
              (256) puts the 1,024-query and the 256-query batches on the
              query axis, both from the initial tiers. Each phase-5
              call three times on each (eager, captured, replayed): the
              first of an adaptive family climbs the ladder on merged ok
              flags and must settle at phase 5's tier; every result held
              against phase 5's unmeshed result
              (bitwise, or by DESIGN.md §10's compaction rule for
              materialized ids and kNN ties), with the NCCL collectives
              and the kernel launches of the last call (the kernels' the
              unmeshed engine's per call, taken before the mesh's counts
              are set to 0, so that those are the meshed engines' own),
              each call's wall meshed beside
              unmeshed, qshard_executables, the graphs and their pool's
              bytes; then a q = 16 serving round on each under sync-debug
              "error" (host_syncs +0). Meshed programs run as CUDA graphs,
              their collectives captured with them: printed, and a capture
              that fails raises. The earlier engines' graphs are released
              first;
 12. kernels  each of the seven kernels against its plain version at the
              shapes the main path gives it (bitwise; morton on the
              quantized coordinates of the 2^23 build, at its own entry
              point, and also against core/keys.morton_encode), with its
              device time per main-path call, the plain version's and one
              library call's where PyTorch has one (CUDA events with the
              stream held busy by a spin kernel while the host enqueues,
              so no launch gap is timed; morton also with a cold L2), the
              mean time of the call's activities in a torch.profiler
              trace and how many the trace held, and the bound from this
              run's inputs (bytes over 3.35 TB/s, or operations over 67
              TFLOP/s for float32 and 16.7 TOP/s for int32, whichever is
              larger). ``launches`` counts every path this script drives
              (main, serve, wide, updates, scheduler,
              morton). spline_search is also held
              equal to torch.searchsorted (its library call) on every
              chunk, with
              the floor of as many one-element PyTorch launches beside
              it; knn_topk is also held bitwise and timed at the serving
              fallback's shape (SERVE_Q queries on the same chunks), with
              its launch plans; range_count, circle_count and
              point_in_polygon (the three instances of the interval
              scan) must make one launch per chunk on their main-path
              calls, and report their grid, the spread of their learned
              intervals (p50/p90/p99/max, each launch's total positions
              and longest interval), each chunk's device time and,
              bitwise too, their time at the serving shape (the first
              SERVE_Q queries, or SERVE_POLYGONS polygons, of the same
              chunks); each kernel instance's ptxas registers, stack and
              spills go to the report (the three instances must have no
              stack and no spills); point_probe (the fused point query:
              candidate filter, learned lookup and probe scan in one
              launch per call, a warp per query and candidate) is held
              bitwise on two launches in a row and timed, with its
              registers, stack and spills, and once more on a shard of
              the partitions (part_offset > 0, the upper half of the
              planes) bitwise its plain version with the same offset;
              beside it
              the floor of one launch on the card at its grid: an empty
              kernel (csrc/launch_floor.cu, on no query path) timed the
              same way;
 13. denormals the four kernels that read float32 denormals as zero
              (range_count, circle_count, knn_topk, point_in_polygon) on
              tests/test_torch_gpu.py's denormal points and queries, each
              bitwise its plain version on the card, which must equal the
              plain version on the CPU; the kernels line's max_abs_err of
              those four is the larger of the main path's and this.

Device busy time and idle share come from torch.profiler traces; each
trace is checked against the wrappers' launch counts (``traced``): a
long trace can lose activities, and its retention is printed with it.

It prints the kernels line, the card line and, last, the result line.
Details also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# int32 operations/s on the CUDA cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper white paper)
PEAK_I32 = 16.7e12
N_POINTS = 1 << 23
N_PARTS = 128
SERVE_Q = 16             # src/repro/launch/serve.py's narrow traffic
SERVE_POLYGONS = max(SERVE_Q // 8, 4)    # its join's polygons
SERVE_ROUNDS = 4
WIDE_Q = 64              # src/repro/launch/serve.py's default --batch
WIDE_ROUNDS = 3
# the update phase: inserts from the taxi generator (another seed), and
# deletes of originals and of still-buffered inserts
UPD_INSERTS = 8192
UPD_DELETES = 3072
UPD_BUFFERED = 1024
UPD_SERVE_INSERTS = 1024     # between two serving rounds
UPD_SERVE_OCCUPANCY = 1e-4   # low enough that this insert schedules re-fits
# the scheduler phase: src/repro/launch/serve.py --spatial --scheduler's
# traffic at its --batch 64 --rounds 8 (512 single-query requests, point,
# range count, 10-NN, circle round-robin) from 8 client threads
SCHED_BATCH = 64
SCHED_ROUNDS = 8
SCHED_CLIENTS = 8
SCHED_SERIAL_S = 60.0    # the serial replay's budget (else 64 of each kind)
# the kernels the scheduler's traffic launches (it has no join)
SCHED_KERNELS = ("spline_search", "range_count", "point_probe", "knn_topk",
                 "circle_count")
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
DEVICE = "cuda"          # where the port runs, and the kernel backend
BACKEND = "cuda"
REPLACES = {
    "spline_search": "src/repro/kernels/spline_search.py:94",
    "range_count": "src/repro/kernels/range_filter.py:57",
    "point_probe": "src/repro/kernels/point_probe.py:47",
    "knn_topk": "src/repro/kernels/knn_topk.py:83",
    "circle_count": "src/repro/kernels/circle_filter.py:63",
    "point_in_polygon": "src/repro/kernels/point_in_polygon.py:52",
    "morton": "src/repro/kernels/morton.py:40",
}
SOURCES = {
    "spline_search": "src/repro_torch/kernels/csrc/spline_search.cu",
    "range_count": "src/repro_torch/kernels/csrc/range_filter.cu",
    "point_probe": "src/repro_torch/kernels/csrc/point_probe.cu",
    "knn_topk": "src/repro_torch/kernels/csrc/knn_topk.cu",
    "circle_count": "src/repro_torch/kernels/csrc/circle_filter.cu",
    "point_in_polygon": "src/repro_torch/kernels/csrc/point_in_polygon.cu",
    "morton": "src/repro_torch/kernels/csrc/morton.cu",
}
# the kernels the query paths launch (the main path, and each steady
# serving round: the fallbacks' and the point query's); morton has only
# its own entry point
PATH_KERNELS = ("spline_search", "range_count", "point_probe", "knn_topk",
                 "circle_count", "point_in_polygon")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean stream time of one call, CUDA events over ``reps`` calls
    after one warm call. For a short kernel this is the host's enqueue
    rate (the wrapper's checks), not the kernel's own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _short(name: str) -> str:
    """A device activity's name without return type, namespace and
    parameter list (a CUDA kernel's name is its C++ signature)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0]
    return name[:80]


# seconds spent in device_profile, the profiler's own cost included
PROFILE_S = [0.0]


def device_profile(fn, reps: int, counts=None, warm: bool = True) -> dict:
    """{device activity name: device ms per call} over ``reps`` calls
    (after one warm call, unless ``warm`` is False), from a
    torch.profiler (CUPTI) trace's raw activities; empty when the trace
    holds no device activity. ``counts``, a dict, gets {name: activities
    per call}, to show that the trace holds every launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_in = time.perf_counter()
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    # the trace's raw activities: building prof.events()' tree of
    # FunctionEvents takes minutes for a trace of 10^5 activities
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            key = _short(e.name())
            out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6
            if counts is not None:
                counts[key] = counts.get(key, 0) + 1 / reps
    PROFILE_S[0] += time.perf_counter() - t_in
    return {k: v / reps for k, v in out.items()}


# this port's kernels as the trace names them
OUR_KERNELS = ("spline_search_kernel", "interval_count_kernel",
               "point_query_kernel", "knn_topk_kernel", "morton_kernel")
POINT_TRACE = "point_query_kernel"
# range_count's, circle_count's and the join's instances of the shared
# interval scan
RANGE_TRACE = "interval_count_kernel<RectTest>"
CIRCLE_TRACE = "interval_count_kernel<CircleTest>"
POLYGON_TRACE = "interval_count_kernel<PolygonTest>"


def traced(fn, reps: int, counts=None, warm: bool = True) -> tuple:
    """(device_profile(fn, reps), retention): the share of this port's
    kernel launches during the traced calls (counted by the wrappers)
    that the trace holds, or None when the calls launch none of them.
    A retention below 1 means the trace lost activities, and its busy
    time is short by about as much. ``counts``, a dict, gets the trace's
    activities per call by name."""
    from repro_torch import kernels as KERN
    counts = {} if counts is None else counts
    KERN.reset_launch_counts()
    prof = device_profile(fn, reps, counts, warm)
    launched = sum(KERN.launch_counts().values()) * reps / (reps + warm)
    held = sum(v * reps for k, v in counts.items()
               if any(o in k for o in OUR_KERNELS))
    return prof, (held / launched if launched else None)


def stream_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device time of one call from CUDA events: before each call a
    spin kernel (``torch.cuda._sleep``, about four times the longest of
    three host enqueue times of a call: host jitter must not outrun it)
    keeps the stream busy while the host enqueues the call between two
    events, so the events time its device work with no launch gaps.
    ``cold``: a 1 GiB fill first evicts the 50 MB L2."""
    import torch
    fn()
    torch.cuda.synchronize()
    host_s = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    cycles = int(host_s * 2e9 * 4) + 200_000
    flush = (torch.empty(1 << 28, dtype=torch.float32, device="cuda")
             if cold else None)
    total = 0.0
    for _ in range(reps):
        if cold:
            flush.fill_(1.0)
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def timed(fn, reps: int, match=None) -> dict:
    """Device time per call from CUDA events with the stream held busy
    (``stream_ms``); the host's enqueue rate (``cuda_ms``); and from a
    profiler trace, the activities whose name contains ``match`` (or all
    of them): their mean time per traced activity and how many the trace
    holds per call (a trace can lose activities)."""
    counts: dict = {}
    prof = device_profile(fn, reps, counts)
    dev = sum(v for k, v in prof.items() if match is None or match in k)
    n = sum(v for k, v in counts.items() if match is None or match in k)
    return {"ms": stream_ms(fn, min(reps, 20)), "wall_ms": cuda_ms(fn, reps),
            "source": "cuda events, stream held busy",
            "trace_ms_per_activity": dev / n if n else None,
            "trace_events_per_call": n}


def host_ms(fn, reps: int, warm: bool = True) -> float:
    """Median wall time of one synchronised call (after a warm call)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def covered(lo, hi, n: int) -> int:
    """Positions covered by the union of the [lo, hi) intervals of each
    row: lo, hi (R, Q) int in [0, n]; counted with a difference array."""
    import torch
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    keep = (hi > lo).to(torch.int64)
    d = torch.zeros((lo.shape[0], n + 1), dtype=torch.int64,
                    device=lo.device)
    d.scatter_add_(1, lo, keep)
    d.scatter_add_(1, hi, -keep)
    return int((d.cumsum(1)[:, :n] > 0).sum())


def require(cond, what: str):
    if not cond:
        raise AssertionError(what)


def golden_inputs(ds, fit):
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
    cx, cy = x[ix[16:28]], y[ix[16:28]]
    cr = np.full(12, 0.04, np.float32)
    polys, ne = ds.random_polygons(8, part.bounds, seed=17)
    return x, y, part, qx, qy, rects, cx, cy, cr, polys, ne


def replay_golden(eng, qx, qy, rects, cx, cy, cr, polys, ne) -> dict:
    """Every golden key, in gen_golden.py's order on one engine."""
    out = {"point": eng.point_query(qx, qy).tolist(),
           "range_count": eng.range_count(rects).tolist()}
    cnt, vids, ok = eng.range_query(rects)
    out.update(range_query_cnt=cnt.tolist(), range_query_vids=vids.tolist(),
               range_query_ok=ok.tolist())
    out["circle_count"] = eng.circle_count(cx, cy, cr).tolist()
    d2, vid = eng.knn(qx, qy, 5, mode="pruned")
    out.update(knn_d2=d2.tolist(), knn_vid=vid.tolist())
    d2, vid = eng.knn(qx[:8], qy[:8], 3, mode="exact")
    out.update(knn_exact_d2=d2.tolist(), knn_exact_vid=vid.tolist())
    out["join_count"] = eng.join_count(polys, ne).tolist()
    return out


def same(a, b) -> bool:
    """Bitwise equality of two results (a tensor or a tuple of them)."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def oracle_checks(x, y, qx, qy, rects, kx, ky, found, counts, d2, vid, k):
    """numpy brute force on the first 64 queries of each kind."""
    for i in range(64):
        hit = bool(np.any((x == qx[i]) & (y == qy[i])))
        require(hit == bool(found[i]), f"point oracle, query {i}")
        r = rects[i]
        n = int(np.count_nonzero((x >= r[0]) & (x <= r[2]) &
                                 (y >= r[1]) & (y <= r[3])))
        require(n == int(counts[i]), f"range oracle, query {i}")
        dd = ((x.astype(np.float64) - kx[i]) ** 2 +
              (y.astype(np.float64) - ky[i]) ** 2)
        best = np.sort(np.partition(dd, k)[:k])
        require(np.allclose(d2[i], best, rtol=1e-6, atol=1e-12),
                f"knn oracle distances, query {i}")
        require(np.allclose(dd[vid[i]], d2[i], rtol=1e-6, atol=1e-12),
                f"knn oracle ids, query {i}")


def range_oracle_ids(x, y, order, xs, rect):
    """Ids of the points inside ``rect`` (closed), by numpy brute force
    over the points whose x lies in the rect's x range (``xs`` is x
    sorted, ``order`` its argsort)."""
    cand = order[np.searchsorted(xs, rect[0], side="left"):
                 np.searchsorted(xs, rect[2], side="right")]
    return np.sort(cand[(y[cand] >= rect[1]) & (y[cand] <= rect[3])])


def serve_round(x, y, part, seed, dev, q=SERVE_Q):
    """src/repro/launch/serve.py's make_round at ``q`` queries (its join
    max(q // 8, 4) polygons), its inputs on the card."""
    import torch
    from repro_torch.core.plan import (CircleQuery, Knn, PointQuery,
                                       RangeCount, RangeQuery, SpatialJoin)
    from repro_torch.data import spatial as ds
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, len(x), q)
    rects = ds.random_rects(q, 1e-5, part.bounds, seed=seed, centers=(x, y))
    polys, ne = ds.random_polygons(max(q // 8, 4), part.bounds, seed=seed)
    px, py, pr, rc, pl, pn = (
        torch.as_tensor(np.ascontiguousarray(a), device=dev)
        for a in (x[ix], y[ix], np.full(q, 0.02, np.float32), rects, polys,
                  ne))
    return [(PointQuery(), px, py), (RangeCount(), rc), (RangeQuery(), rc),
            (CircleQuery(), px, py, pr), (Knn(k=10), px, py),
            (SpatialJoin(), pl, pn)]


def main_inputs(x, y, part):
    """Phase 5's queries, from seeds: (qx, qy) 512 data points and 512
    random points; 1,024 rects at selectivity 1e-5; kx, ky the 256 kNN
    queries; then src/repro/launch/spatial.py's traffic: 256 rects, 256
    circles of r = 0.01 on data points, 32 polygons."""
    from repro_torch.data import spatial as ds
    rng = np.random.default_rng(1)
    ix = rng.integers(0, len(x), 512)
    qx = np.concatenate([x[ix], rng.random(512).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(512).astype(np.float32)])
    rects = ds.random_rects(1024, 1e-5, part.bounds, seed=2, centers=(x, y))
    kx, ky = qx[256:512], qy[256:512]
    rq_rects = ds.random_rects(256, 1e-5, part.bounds, seed=3,
                               centers=(x, y))
    cix = rng.integers(0, len(x), 256)
    cx, cy = x[cix], y[cix]
    cr = np.full(256, 0.01, np.float32)
    polys, ne = ds.random_polygons(32, part.bounds, seed=4)
    return qx, qy, rects, kx, ky, rq_rects, cx, cy, cr, polys, ne


def full_index(dev):
    """Phase 4's data, partitioning and index: taxi, N_POINTS points,
    seed 0, kdtree with N_PARTS partitions. Returns (x, y, part, index,
    data seconds, build seconds)."""
    import torch
    from repro_torch.core import build_index, fit
    from repro_torch.data import spatial as ds
    t0 = time.perf_counter()
    x, y = ds.make("taxi", N_POINTS, seed=0)
    part = fit("kdtree", x, y, N_PARTS, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(x, y, part, device=dev)
    torch.cuda.synchronize()
    return x, y, part, index, data_s, time.perf_counter() - t0


def interval_spread(launches) -> dict:
    """The learned intervals of one call's launches, each given as (s, e,
    active, count, n_pad): lengths max(0, min(e, count, n_pad) -
    max(s, 0)) of the active pairs; their p50/p90/p99/max over the
    non-empty ones, and each launch's total positions and longest
    interval."""
    import torch
    per_total, per_long, lens = [], [], []
    for s, e, act, count, n_pad in launches:
        hi = torch.minimum(e, count[:, None]).clamp(max=n_pad)
        ln = torch.where(act, (hi - s.clamp(min=0)).clamp(min=0), 0)
        per_total.append(int(ln.sum()))
        per_long.append(int(ln.max()) if ln.numel() else 0)
        lens.append(ln[ln > 0].double())
    lens = torch.cat(lens)
    q = torch.tensor([0.5, 0.9, 0.99], dtype=lens.dtype, device=lens.device)
    q = torch.quantile(lens, q).tolist() if lens.numel() else [0.0] * 3
    return {"non_empty": int(lens.numel()), "positions": sum(per_total),
            "p50": q[0], "p90": q[1], "p99": q[2],
            "max": int(lens.max()) if lens.numel() else 0,
            "per_launch_positions": per_total, "per_launch_longest": per_long}


def ptxas_summary(lines) -> dict:
    """Registers, stack and spill bytes of every kernel instance in an
    nvcc -Xptxas -v report's lines."""
    import re
    regs = [int(m.group(1)) for ln in lines
            for m in [re.search(r"Used (\d+) registers", ln)] if m]
    frames = [tuple(map(int, m.groups())) for ln in lines
              for m in [re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                  r"spill stores, (\d+) bytes spill loads",
                                  ln)] if m]
    return {"registers": regs, "stack": [f[0] for f in frames],
            "spill_stores": [f[1] for f in frames],
            "spill_loads": [f[2] for f in frames]}


def count_launch_args(ex, rects, klo, khi, circ=None) -> list:
    """The arguments of each range_count launch (``circ`` None) or
    circle_count launch of one exact call of executor ``ex`` on
    ``rects`` (circle MBRs) with key bounds ``klo``, ``khi``: one tuple
    per chunk of ``ex.cfg.part_chunk`` partitions, its learned bounds
    from the plain backend."""
    from repro_torch.core import local_ops as L
    from repro_torch.core import queries as Q
    from repro_torch.core.backends import TorchBackend
    kw = dict(radix_bits=ex.index.radix_bits, probe=ex.index.probe)
    c = ex.cfg.part_chunk
    overlap = Q.rect_overlaps_box(rects, ex.bounds)
    mid = () if circ is None else (circ,)
    out = []
    for lo, ch in L._chunks(ex.parts, c):
        s, e = TorchBackend().bounds(ch, klo, khi, **kw)
        act = overlap[:, lo:lo + c].t().contiguous()
        out.append((rects, s, e, *mid, act, ch["count"], ch["x"], ch["y"]))
    return out


def interval_ends(args, first: int = 1) -> tuple:
    """(s, hi) over all of ``count_launch_args``' (or, ``first`` = 3,
    ``join_launch_args``') launches, hi = min(e, count) on active pairs
    and s on the others."""
    import torch
    s = torch.cat([a[first] for a in args])
    hi = torch.cat([torch.where(a[-4], torch.minimum(a[first + 1],
                                                     a[-3][:, None]),
                                a[first]) for a in args])
    return s, hi


def first_queries(args, q: int) -> tuple:
    """A count launch's arguments cut to its first ``q`` queries: the
    rects (and circles) are query-major, s, e and active pair-major."""
    rects, s, e, *mid, act, count, x, y = args
    cut = [rects[:q], s[:, :q], e[:, :q], *(m[:q] for m in mid), act[:, :q]]
    return (*(t.contiguous() for t in cut), count, x, y)


def join_launch_args(ex, polys, ne) -> list:
    """The arguments of each join_count launch of one full join of
    executor ``ex`` on ``polys`` (numpy, with edge counts ``ne``): one
    tuple per chunk of ``ex.cfg.part_chunk`` partitions, its learned
    bounds from the plain backend."""
    from repro_torch.core import local_ops as L
    from repro_torch.core import queries as Q
    from repro_torch.core.backends import TorchBackend
    kw = dict(radix_bits=ex.index.radix_bits, probe=ex.index.probe)
    c = ex.cfg.part_chunk
    jpoly, jne, jmbr_k = ex._join_args((polys, ne))
    jmbrs = jmbr_k[:, :4].contiguous()
    jklo, jkhi = jmbr_k[:, 4].contiguous(), jmbr_k[:, 5].contiguous()
    overlap = Q.rect_overlaps_box(jmbrs, ex.bounds)
    out = []
    for lo, ch in L._chunks(ex.parts, c):
        s, e = TorchBackend().bounds(ch, jklo, jkhi, **kw)
        act = overlap[:, lo:lo + c].t().contiguous()
        out.append((jpoly, jne, jmbrs, s, e, act, ch["count"], ch["x"],
                    ch["y"]))
    return out


def first_polygons(args, q: int) -> tuple:
    """A join_count launch's arguments cut to its first ``q`` polygons:
    polygons, edge counts and MBRs are polygon-major, s, e and active
    pair-major."""
    polys, ne, mbrs, s, e, act, count, x, y = args
    cut = [polys[:q], ne[:q], mbrs[:q], s[:, :q], e[:, :q], act[:, :q]]
    return (*(t.contiguous() for t in cut), count, x, y)


def serve_checks(sx, reqs, out, what: str):
    """A serving round's outputs against the exact programs on executor
    ``sx``: every data point found, range query counts == range count,
    circle counts == the exact circle program, kNN d2 == exact kNN, the
    join == the full join."""
    import torch
    from repro_torch.core.plan import Knn, SpatialJoin
    require(bool(out[0].all()), f"{what}: every data point is found")
    require(torch.equal(out[2][0], out[1]),
            f"{what}: range query counts == range count")
    require(torch.equal(out[3], sx._circle_exact(
        sx._circle_args(reqs[3][1:]))),
        f"{what}: circle counts == the exact circle program")
    d2e, _ = sx.run(Knn(k=10, mode="exact"), *reqs[4][1:])
    require(torch.equal(out[4][0], d2e), f"{what}: kNN d2 == exact kNN")
    require(torch.equal(out[5], sx.run(SpatialJoin(mode="full"),
                                       *reqs[5][1:])),
            f"{what}: join == the full join")


def serve_phase(index, part, x, y, dev) -> tuple:
    """Phase 6: serving mode on ``index`` (see the module docstring).
    Returns (report, {kernel: launches over the steady rounds}, the
    sticky tiers after warmup, the session, its torch backend's)."""
    import torch
    from repro_torch import kernels as KERN
    from repro_torch.core import EngineConfig
    from repro_torch.core import local_ops as L
    from repro_torch.serve import SpatialServeSession

    sess = SpatialServeSession(index, device=DEVICE)
    plain = SpatialServeSession(index, EngineConfig(backend="torch"),
                                device=DEVICE)
    sx, px_ = sess.executor, plain.executor
    rounds = [serve_round(x, y, part, seed, dev)
              for seed in range(SERVE_ROUNDS + 1)]
    # the same session running every program eagerly: its rounds'
    # wall beside the graphs', and the fallbacks' share of a round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.warmup(rounds[0])
    torch.cuda.synchronize()
    report = {"q": SERVE_Q, "warmup_s": time.perf_counter() - t0}
    plain.warmup(rounds[0])
    warm_tiers = dict(sx._sticky)
    report["tiers_after_warmup"] = {str(k): v for k, v in sx._sticky.items()}
    require(set(sx._sticky) == {("range",), ("circle", False), ("knn", 10),
                                ("join",)}, f"serve: sticky {sx._sticky}")
    require(sx._sticky == px_._sticky, "serve: torch backend tiers")
    log(f"[serve] warmup {report['warmup_s']:.1f} s, tiers "
        f"{report['tiers_after_warmup']}")

    launches = {n: 0 for n in KERN.KERNELS}
    report["rounds"] = []
    for i in range(1, SERVE_ROUNDS + 1):
        reqs = rounds[i]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = sx.host_syncs
        KERN.reset_launch_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sess.submit_batch(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = KERN.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(sx.host_syncs == syncs, f"serve round {i}: host_syncs moved")
        require(all(got[n] > 0 for n in PATH_KERNELS),
                f"serve round {i}: launches {got}")
        require(got["point_probe"] == 1,
                f"serve round {i}: the point request launched "
                f"{got['point_probe']} point kernels")
        for n, c in got.items():
            launches[n] += c
        for j, (a, b) in enumerate(zip(out, plain.submit_batch(reqs))):
            require(same(a, b), f"serve round {i}, request {j}: cuda vs "
                    "torch backend")
        serve_checks(sx, reqs, out, f"serve round {i}")
        moved = sess.maintain()
        require(moved == plain.maintain() and sx._sticky == px_._sticky,
                f"serve round {i}: maintain() differs between backends")
        row = {"round": i, "wall_ms": ms, "host_syncs_added": 0,
               "launches": {n: c for n, c in got.items() if c},
               "maintain": {str(k): v for k, v in moved.items()},
               "max_memory_allocated": peak}
        row["memory_reserved"] = torch.cuda.memory_reserved()
        row["graph_pool_bytes"] = pool_bytes(sx)
        report["rounds"].append(row)
        log(f"[serve] round {i}: {ms:.1f} ms, host_syncs +0, launches "
            f"{row['launches']}, maintain {row['maintain']}, "
            f"max_memory_allocated {peak}, graph pool "
            f"{row['graph_pool_bytes']}, memory_reserved "
            f"{row['memory_reserved']}")
    report["graphs"] = graph_count(sx)
    report["capture_ms_total"] = sx.compile_ms_total
    report["cache_size"] = sx.stats()["cache_size"]
    log(f"[serve] {report['graphs']} graphs in {report['cache_size']} "
        f"cached programs, captured in {sx.compile_ms_total:.1f} ms")

    # one steady round traced; the fused programs' fallbacks are taken
    # from the same round on an eager session (its programs run op by
    # op), and traced alone on the same inputs for their share of
    # device time
    reqs = rounds[1]
    prof, kept = traced(lambda: sess.submit_batch(reqs), 1)
    eager = SpatialServeSession(index, device=DEVICE)
    eager.executor.cuda_graphs = False
    eager.executor._sticky.update(sx._sticky)
    eager.submit_batch(reqs)
    captured = []
    fused_call = L._CondFusedLocal.__call__

    def capture(self, parts, bounds, *qa):
        captured.append((self.fallback, parts, bounds,
                         tuple(qa[j] for j in self.fb_args)))
        return fused_call(self, parts, bounds, *qa)

    L._CondFusedLocal.__call__ = capture
    try:
        for a, b in zip(eager.submit_batch(reqs), sess.submit_batch(reqs)):
            require(same(a, b), "serve: eager session vs graphs")
    finally:
        L._CondFusedLocal.__call__ = fused_call
    fbs = captured[-4:]             # range, circle, kNN, join

    def fallbacks():
        return [fb(pa, bo, *a) for fb, pa, bo, a in fbs]

    fb_prof, fb_kept = traced(fallbacks, 1)
    wall = host_ms(lambda: sess.submit_batch(reqs), 3)
    busy, fb_busy = sum(prof.values()), sum(fb_prof.values())
    report.update(
        steady_round_ms=wall, device_busy_ms=busy,
        idle_share=1.0 - busy / wall, trace_retention=kept,
        fallback_busy_ms=fb_busy, fallback_trace_retention=fb_kept,
        fallback_share=fb_busy / busy,
        top_device_ms=sorted(prof.items(), key=lambda kv: -kv[1])[:6])
    log(f"[serve] steady round {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(trace retention {kept:.3f}), idle share "
        f"{report['idle_share']:.3f}, fallback programs {fb_busy:.3f} ms "
        f"(retention {fb_kept:.3f}; {report['fallback_share']:.3f} of "
        "device time)")
    log("[serve] where: " + "; ".join(
        f"{n} {t:.4f}" for n, t in report["top_device_ms"]))
    report["request_ms"] = {
        n: host_ms(lambda r=r: sess.submit(*r), 3)
        for n, r in zip(SERVE_NAMES, reqs)}
    report["request_ms_eager"] = {
        n: host_ms(lambda r=r: eager.submit(*r), 3)
        for n, r in zip(SERVE_NAMES, reqs)}
    report["steady_round_ms_eager"] = host_ms(
        lambda: eager.submit_batch(reqs), 3)
    log("[serve] per request ms, graphs (eager): " + ", ".join(
        f"{n} {t:.3f} ({report['request_ms_eager'][n]:.3f})"
        for n, t in report["request_ms"].items()))
    log(f"[serve] eager steady round {report['steady_round_ms_eager']:.3f}"
        " ms")
    release(eager.executor)
    del eager

    # pruned kNN at its sticky tier: the serving form's fixed rounds
    # against the strict form's early exit, on the round's queries
    cap = sx._sticky[("knn", 10)][0]
    kq = reqs[4][1:]
    r0 = sx._knn_r0(*kq, 10)
    knn = {}
    for fixed in (False, True):
        prog = L._KnnPrunedLocal(sx.index, sx.cfg, sx.backend, 10,
                                 sx.cfg.knn_cand, cap, fixed_rounds=fixed)
        knn["fixed" if fixed else "early_exit"] = {
            "wall_ms": host_ms(lambda: prog(sx.parts, sx.bounds, *kq, r0),
                               3),
            "device_busy_ms": sum(device_profile(
                lambda: prog(sx.parts, sx.bounds, *kq, r0), 1).values())}
    report["knn_rounds"] = dict(knn, tier=cap, max_rounds=sx.cfg.knn_max_rounds)
    log(f"[serve] pruned 10-NN at cap {cap}: {sx.cfg.knn_max_rounds} fixed "
        f"rounds {knn['fixed']['wall_ms']:.3f} ms (device "
        f"{knn['fixed']['device_busy_ms']:.3f}), early exit "
        f"{knn['early_exit']['wall_ms']:.3f} ms (device "
        f"{knn['early_exit']['device_busy_ms']:.3f})")

    require(sess.stats()["probe_syncs"] == 0,
            "serve: a q = 16 round made a bucketing probe")
    report["stats"] = {k: (str(v) if k == "sticky" else v)
                       for k, v in sess.stats().items()}
    report["precompiled_move"] = precompiled_sticky_move(index, reqs[2],
                                                         plain)
    return report, launches, warm_tiers, sess, plain


def precompiled_sticky_move(index, req, plain) -> dict:
    """Phase 6's last step: a new session warmed on the round's range
    query ``req``, its precompile worker started, then two escalations
    of the range family through maintain(), each forced by a request of
    whole-domain rectangles (every query overflows every tier below the
    top). After the first move the worker must have captured the fused
    program of the tier above the new sticky one, at the round's
    signature, before any request needed it; the second move makes that
    tier sticky, and the round's range query then replays the worker's
    graph: the serving thread captures nothing, and the counts equal the
    torch backend's."""
    import torch
    from repro_torch.core.executor import _Graph
    from repro_torch.core.plan import RangeQuery
    from repro_torch.serve import SpatialServeSession

    mv = SpatialServeSession(index, device=DEVICE)
    ex = mv.executor
    base = ("range",)
    mv.warmup([req])
    sigs = ex._cache[ex._key(base, "fused", ex._sticky[base])].sigs()
    require(ex.start_precompiler(), "serve: the precompile worker")
    rects = req[1]
    whole = torch.as_tensor(np.asarray(index.key_spec.bounds, np.float32),
                            device=rects.device)
    big = (RangeQuery(), whole.expand(rects.shape[0], 4).contiguous())
    tiers = [ex._sticky[base]]
    ahead = None
    for step in (1, 2):
        mv.submit(*big)                   # overflows the sticky tier
        moved = mv.maintain()
        require(base in moved, f"serve: move {step} did not happen: {moved}")
        tiers.append(ex._sticky[base])
        require(ex.precompile_quiesce(300.0), "serve: the worker hung")
        if step == 1:
            ahead = ex._escalators[base](*tiers[-1])
            disp = ex._cache.get(ex._key(base, "fused", ahead))
            require(disp is not None and all(
                isinstance(disp._fns.get(sg), _Graph) for sg in sigs),
                f"serve: the tier {ahead} above the new sticky "
                f"{tiers[-1]} was not captured ahead of need")
    require(tiers[2] == ahead, f"serve: the moves went {tiers}")
    torch.cuda.synchronize()
    serving, compiled = ex.capture_ms["serving"], ex.async_compiles
    out = mv.submit(*req)
    torch.cuda.synchronize()
    require(ex.capture_ms["serving"] == serving == 0.0,
            "serve: the serving thread captured at the precompiled tier")
    require(same(out[0], plain.submit(*req)[0]),
            "serve: counts at the precompiled tier vs the torch backend")
    st = ex.stats()
    require(st["async_capture_errors"] == 0, "serve: worker captures "
            "failed")
    ex.stop_precompiler()
    rep = {"tiers": [list(t) for t in tiers], "ahead": list(ahead),
           "async_compiles": compiled,
           "worker_capture_ms": ex.capture_ms["worker"],
           "graph_pool_bytes": pool_bytes(ex)}
    release(ex)
    log(f"[serve] precompiled sticky move: range tiers {rep['tiers']}, the "
        f"tier {rep['ahead']} captured by the worker before the move to "
        f"it ({compiled} worker captures, {rep['worker_capture_ms']:.1f} "
        "ms on the worker, 0 on the serving thread)")
    return rep


def wide_serve_phase(index, part, x, y, dev) -> tuple:
    """Phase 8: serving mode at src/repro/launch/serve.py's default batch
    (WIDE_Q queries, at or above tier_bucket_min), where each adaptive
    family with that many rows takes the tier-bucketed dispatch. Returns
    (report, {kernel: launches over the steady rounds})."""
    import warnings

    import torch
    from repro_torch import kernels as KERN
    from repro_torch.core import EngineConfig
    from repro_torch.serve import SpatialServeSession

    sess = SpatialServeSession(index, device=DEVICE)
    plain = SpatialServeSession(index, EngineConfig(backend="torch"),
                                device=DEVICE)
    sx, px_ = sess.executor, plain.executor
    rounds = [serve_round(x, y, part, seed, dev, WIDE_Q)
              for seed in range(WIDE_ROUNDS + 1)]
    # the adaptive requests wide enough to be bucketed
    min_q = sx.cfg.tier_bucket_min
    bucketed = [i for i in (2, 3, 4, 5) if rounds[0][i][1].shape[0] >= min_q]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.warmup(rounds[0])
    torch.cuda.synchronize()
    report = {"q": WIDE_Q, "warmup_s": time.perf_counter() - t0,
              "bucketed_requests": len(bucketed)}
    plain.warmup(rounds[0])
    require(sx._sticky == px_._sticky, "wide serve: torch backend tiers")
    report["tiers_after_warmup"] = {str(k): v for k, v in sx._sticky.items()}
    log(f"[wide] q = {WIDE_Q}: warmup {report['warmup_s']:.1f} s, tiers "
        f"{report['tiers_after_warmup']}; {len(bucketed)} requests "
        "bucketed per round")

    # each fused call of a bucketed request: (family, tier, rows padded
    # to a power of two)
    buckets = []
    fused_chunked = sx._fused_chunked

    def spy(op, tier, bargs, width):
        buckets.append((str(op.base), list(tier), int(width)))
        return fused_chunked(op, tier, bargs, width)

    sx._fused_chunked = spy
    launches = {n: 0 for n in KERN.KERNELS}
    report["rounds"] = []
    for i in range(1, WIDE_ROUNDS + 1):
        reqs = rounds[i]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs, probes = sx.host_syncs, sx.probe_syncs
        buckets.clear()
        KERN.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = sess.submit_batch(reqs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = KERN.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_sync = sum(SYNC_WARNING in str(w.message) for w in caught)
        grew = sx.probe_syncs - probes
        require(sx.host_syncs == syncs,
                f"wide round {i}: host_syncs moved")
        require(grew == len(bucketed),
                f"wide round {i}: probe_syncs grew by {grew}, "
                f"{len(bucketed)} bucketed requests")
        require(n_sync == grew, f"wide round {i}: {n_sync} sync warnings "
                f"for {grew} probe reads")
        require(all(got[n] > 0 for n in PATH_KERNELS),
                f"wide round {i}: launches {got}")
        require(got["point_probe"] == 1,
                f"wide round {i}: {got['point_probe']} point kernels")
        for n, c in got.items():
            launches[n] += c
        for j, (a, b) in enumerate(zip(out, plain.submit_batch(reqs))):
            require(same(a, b), f"wide round {i}, request {j}: cuda vs "
                    "torch backend")
        serve_checks(sx, reqs, out, f"wide round {i}")
        moved = sess.maintain()
        require(moved == plain.maintain() and sx._sticky == px_._sticky,
                f"wide round {i}: maintain() differs between backends")
        row = {"round": i, "wall_ms": ms, "wall_ms_per_request":
               ms / len(reqs), "host_syncs_added": 0,
               "probe_syncs_added": grew, "sync_warnings": n_sync,
               "buckets": list(buckets),
               "launches": {n: c for n, c in got.items() if c},
               "maintain": {str(k): v for k, v in moved.items()},
               "max_memory_allocated": peak,
               "graph_pool_bytes": pool_bytes(sx),
               "capture_ms_total": sx.compile_ms_total}
        report["rounds"].append(row)
        log(f"[wide] round {i}: {ms:.1f} ms ({ms / len(reqs):.1f} per "
            f"request), host_syncs +0, probe_syncs +{grew}, sync warnings "
            f"{n_sync}, buckets (family, tier, rows) {row['buckets']}, "
            f"launches {row['launches']}, maintain {row['maintain']}, "
            f"max_memory_allocated {peak}, graph pool "
            f"{row['graph_pool_bytes']}, captures so far "
            f"{sx.compile_ms_total:.1f} ms")
    sx._fused_chunked = fused_chunked
    reqs = rounds[1]
    names = ["point", "range_count", "range_query", "circle_count",
             "knn10", "join"]
    report["request_ms"] = {
        n: host_ms(lambda r=r: sess.submit(*r), 3)
        for n, r in zip(names, reqs)}
    log("[wide] per request ms: " + ", ".join(
        f"{n} {t:.3f}" for n, t in report["request_ms"].items()))
    report["steady_round_ms"] = host_ms(lambda: sess.submit_batch(reqs), 3)
    log(f"[wide] steady round {report['steady_round_ms']:.3f} ms")
    report["stats"] = {k: (str(v) if k == "sticky" else v)
                       for k, v in sess.stats().items()}
    return report, launches


def release(*executors) -> None:
    """Drop the executors' cached programs (their CUDA graphs) and give
    the freed memory back to the card."""
    import gc

    import torch
    for ex in executors:
        ex.release()
    gc.collect()
    torch.cuda.empty_cache()


def pool_bytes(ex) -> int:
    """Device bytes the caching allocator holds in the memory pool of an
    executor's CUDA graphs (0 when it has none)."""
    import torch
    if ex._pool is None:
        return 0
    pid = tuple(ex._pool)
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == pid)


def graph_count(ex) -> int:
    """The CUDA graphs an executor holds."""
    from repro_torch.core.executor import _Graph
    return sum(isinstance(r, _Graph) for d in ex._cache.values()
               for r in d._fns.values())


SERVE_NAMES = ["point", "range_count", "range_query", "circle_count",
               "knn10", "join"]
# the restart's kernel store (build/ is git-ignored)
WARM_STORE = ROOT / "build" / "warm_start_store"


def restart_main(argv) -> int:
    """``chip_smoke.py --restart STORE MANIFEST OUT N_POINTS N_PARTS``:
    phase 7 (f), run by the parent in a fresh process. Rebuilds the index
    (the parent's N_POINTS and N_PARTS) and the
    q = 16 serving round 1 from their seeds; a cold session (the
    manifest's sticky tiers only) takes the first call of each family,
    loading each kernel library from the store; then a session given
    ``prewarm(manifest, exercise=True)``, its first call per family,
    and the steady calls. Saves both sessions' outputs to OUT (npz) and
    prints one JSON line."""
    import torch
    from repro_torch import kernels as KERN
    from repro_torch.core import EngineConfig
    from repro_torch.core.compile_cache import load_manifest
    from repro_torch.kernels import _build
    from repro_torch.serve import SpatialServeSession
    global N_POINTS, N_PARTS
    store, man_path, out_path = argv[:3]
    N_POINTS, N_PARTS = int(argv[3]), int(argv[4])
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    x, y, part, index, _, _ = full_index(dev)
    index_s = time.perf_counter() - t0
    man = load_manifest(man_path)
    require(man is not None and man["programs"], "restart: no manifest")
    reqs = serve_round(x, y, part, 1, dev)
    cfg = EngineConfig(compile_cache_dir=store)
    res = {"index_s": index_s, "programs": len(man["programs"])}
    outs = {}

    def first_calls(sess, tag):
        ms, got = {}, []
        for name, r in zip(SERVE_NAMES, reqs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got.append(sess.submit(*r))
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t1) * 1e3
        outs[tag] = got
        return ms

    # cold: no program realized; the sticky tiers as recorded
    cold = SpatialServeSession(index, cfg, device=DEVICE)
    cold.prewarm(dict(man, programs=[]))
    KERN.reset_launch_counts()
    res["cold_ms"] = first_calls(cold, "cold")
    res["libraries_loaded"] = sorted(_build._libs)
    res["disk_cache_hits"] = cold.stats()["disk_cache_hits"]
    res["disk_cache_misses"] = cold.stats()["disk_cache_misses"]
    res["nvcc_compiles"] = _build.compiles
    release(cold.executor)
    del cold
    warm = SpatialServeSession(index, cfg, device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res["prewarm"] = warm.prewarm(man, exercise=True)
    torch.cuda.synchronize()
    res["prewarm_ms"] = (time.perf_counter() - t1) * 1e3
    st0 = warm.stats()
    res["prewarmed_first_ms"] = first_calls(warm, "prewarmed")
    st1 = warm.stats()
    res["prewarmed_new_programs"] = st1["cache_size"] - st0["cache_size"]
    res["prewarmed_capture_ms"] = st1["compile_ms_total"] - \
        st0["compile_ms_total"]
    res["host_syncs_added"] = st1["host_syncs"] - st0["host_syncs"]
    res["steady_ms"] = {
        n: host_ms(lambda r=r: warm.submit(*r), 3, warm=False)
        for n, r in zip(SERVE_NAMES, reqs)}
    res["graphs"] = graph_count(warm.executor)
    res["graph_pool_bytes"] = pool_bytes(warm.executor)
    res["launches"] = KERN.launch_counts()
    np.savez(out_path, **{
        f"{tag}.{i}.{j}": a.cpu().numpy()
        for tag, got in outs.items() for i, o in enumerate(got)
        for j, a in enumerate(o if isinstance(o, tuple) else (o,))})
    print(json.dumps(res))
    return 0


def warm_phase(eng, plain, main_path, main_args, sess, x, y, part, dev,
               card) -> dict:
    """Phase 7: warm start (see the module docstring), on the main path's
    engines and the serve phase's session. Returns the report."""
    import torch
    from repro_torch.core import PointQuery, RangeCount, SpatialEngine
    from repro_torch.core.compile_cache import save_manifest
    from repro_torch.data import spatial as ds
    from repro_torch.kernels import _build
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_gpu import capture_alone, launcher_cases

    ex = eng.executor
    report = {"card": card, "main_graphs": graph_count(ex),
              "main_graph_pool_bytes": pool_bytes(ex),
              "main_capture_ms_total": ex.compile_ms_total}
    log(f"[warm] phase 5's engine: {report['main_graphs']} graphs, pool "
        f"{report['main_graph_pool_bytes']} bytes, captured in "
        f"{ex.compile_ms_total:.1f} ms")
    # (a) each launcher captured alone, at the main path's shapes
    alone = {}
    for name, (fn, a, kw) in launcher_cases(ex, main_args).items():
        eager, replays, launched = capture_alone(fn, a, kw)
        require(launched == {name: 1}, f"warm (a): {name} capture "
                f"recorded {launched}")
        require(all(same(eager, r) for r in replays),
                f"warm (a): {name} replay vs its eager launch")
        alone[name] = "bitwise, 1 launch"
    report["launchers_alone"] = alone
    log(f"[warm] (a) each launcher captured alone into a one-launch "
        f"graph, two replays bitwise its eager launch: {sorted(alone)}")

    # (c) two graphs of one pool, replayed in the reverse of their
    # capture order (point captured before range count in phase 5)
    eager = SpatialEngine(ex.index, device=DEVICE)
    eager.executor.cuda_graphs = False
    order = [k[2][0] for k in ex._cache if k[2] in (("point",),
                                                    ("range_count",))]
    require(order == ["point", "range_count"], f"warm (c): order {order}")
    for seed in (21, 22, 23):
        rng = np.random.default_rng(seed)
        ix = rng.integers(0, len(x), 1024)
        rc = ds.random_rects(1024, 1e-5, part.bounds, seed=seed,
                             centers=(x, y))
        for req in ((RangeCount(), rc), (PointQuery(), x[ix], y[ix])):
            require(torch.equal(eng.run(*req), eager.run(*req)),
                    f"warm (c): {type(req[0]).__name__} replay")
    report["reverse_order_replays"] = 6
    log("[warm] (c) range count then point (the reverse of their capture "
        "order), 3 new inputs each: bitwise an eager engine")
    release(eager.executor)

    # (f) a restart in a subprocess on a warm kernel store and the
    # serve phase's manifest; the parent's answers at the same tiers
    import shutil
    shutil.rmtree(WARM_STORE, ignore_errors=True)
    from repro_torch.core import EngineConfig
    from repro_torch.serve import SpatialServeSession
    keeper = SpatialServeSession(ex.index, EngineConfig(
        compile_cache_dir=str(WARM_STORE)), device=DEVICE)
    h0, m0 = _build.disk_hits, _build.disk_misses
    _build.build_all()          # nvcc builds each library into the store
    report["store"] = {"entries": len(keeper.executor._disk),
                       "bytes": keeper.executor._disk.size_bytes(),
                       "misses": _build.disk_misses - m0,
                       "hits": _build.disk_hits - h0}
    _build.use_store(None)
    del keeper
    ref = sess.submit_batch(serve_round(x, y, part, 1, dev))
    man = sess.manifest()
    mpath = ROOT / "build" / "warm_start_manifest.json"
    save_manifest(mpath, man)
    report["manifest_programs"] = len(man["programs"])
    report["manifest_signatures"] = sum(len(p["sigs"])
                                        for p in man["programs"])
    release(ex, plain.executor, sess.executor)
    out_npz = ROOT / "build" / "warm_start_restart.npz"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--restart", str(WARM_STORE), str(mpath),
                           str(out_npz), str(N_POINTS), str(N_PARTS)],
                          capture_output=True,
                          text=True, timeout=600)
    report["restart_process_s"] = time.perf_counter() - t0
    require(proc.returncode == 0, f"warm (f): the restart failed:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rs = json.loads(proc.stdout.strip().splitlines()[-1])
    report["restart"] = rs
    n_libs = len(rs["libraries_loaded"])
    require(rs["disk_cache_hits"] == n_libs and rs["disk_cache_misses"] == 0
            and rs["nvcc_compiles"] == 0,
            f"warm (f): store hits {rs['disk_cache_hits']}, misses "
            f"{rs['disk_cache_misses']}, nvcc {rs['nvcc_compiles']} for "
            f"{n_libs} libraries")
    require(rs["prewarmed_new_programs"] == 0 and rs["host_syncs_added"] == 0,
            f"warm (f): prewarmed traffic realized "
            f"{rs['prewarmed_new_programs']} programs")
    got = np.load(out_npz)
    for tag in ("cold", "prewarmed"):
        for i, o in enumerate(ref):
            for j, a in enumerate(o if isinstance(o, tuple) else (o,)):
                require(np.array_equal(got[f"{tag}.{i}.{j}"],
                                       a.cpu().numpy()),
                        f"warm (f): {tag} {SERVE_NAMES[i]} leaf {j} "
                        "differs from the parent's")
    log(f"[warm] (f) {card}: restart in {report['restart_process_s']:.1f} s "
        f"(index {rs['index_s']:.1f} s); {n_libs} libraries from the store "
        f"(hits {rs['disk_cache_hits']}, misses {rs['disk_cache_misses']}, "
        f"nvcc runs {rs['nvcc_compiles']}); prewarm "
        f"{rs['prewarm_ms']:.1f} ms ({rs['prewarm']}); first call ms, "
        "cold / prewarmed / steady: " + ", ".join(
            f"{n} {rs['cold_ms'][n]:.1f} / {rs['prewarmed_first_ms'][n]:.1f}"
            f" / {rs['steady_ms'][n]:.3f}" for n in SERVE_NAMES) +
        "; every output bitwise the parent's")
    return report


def same_as_fresh(a, b, materialized: bool) -> tuple:
    """A mutated index's result ``a`` against a fresh build's ``b``:
    counts (and flags), kNN distances and id order bitwise; materialized
    ids equal as sets (the two indexes' window widths differ by the delta
    plane). Returns (equal, kNN rows whose ids differ only in the order
    of equal distances); such a row is no fault (a buffered insert
    follows the main plane before a re-fit), and is counted."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if materialized:
        if not torch.equal(a[0], b[0]):
            return False, 0
        sa = [{v for v in row if v >= 0} for row in a[1].tolist()]
        sb = [{v for v in row if v >= 0} for row in b[1].tolist()]
        return sa == sb, 0
    if len(a) == 2 and a[0].dtype == torch.float32:      # kNN (d2, vid)
        if not torch.equal(a[0], b[0]):
            return False, 0
        if torch.equal(a[1], b[1]):
            return True, 0
        # ids as (d2, id) pairs sorted per row: equal up to tie order
        ka = torch.sort(a[1].to(torch.int64) + (a[0].view(torch.int32)
                        .to(torch.int64) << 32), 1).values
        kb = torch.sort(b[1].to(torch.int64) + (b[0].view(torch.int32)
                        .to(torch.int64) << 32), 1).values
        rows = int((a[1] != b[1]).any(1).sum())
        return bool(torch.equal(ka, kb)), rows
    return all(torch.equal(u, v) for u, v in zip(a, b)), 0


def update_phase(index, part, x, y, dev, main_path, main_args, sticky,
                 serve_tiers, frozen_ms, card) -> tuple:
    """Phase 9: the update path on the full index (see the module
    docstring). Returns (report, {kernel: launches of the driven
    families and serving rounds}, {kernel: max_abs_err of the kernels
    against their plain versions on the mutated and the re-fit index})."""
    import torch
    from repro_torch import kernels as KERN
    from repro_torch.core import (EngineConfig, PointQuery, Refit,
                                  SpatialEngine, build_index)
    from repro_torch.data import spatial as ds
    from repro_torch.serve import SpatialServeSession
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_gpu import (check_kernel_cases, kernel_cases,
                                update_batches)

    u = update_batches(x, y, UPD_INSERTS, UPD_DELETES, UPD_BUFFERED, seed=1)
    eng = SpatialEngine(index, device=DEVICE)
    plain = SpatialEngine(index, EngineConfig(backend="torch"),
                          device=DEVICE)
    plain.executor.cuda_graphs = False      # the reference: eager
    ex = eng.executor
    for e in (eng, plain):
        # the strict loop starts from the frozen index's tiers
        e.executor._sticky.update(sticky)
    report = {"card": card, "inserts": len(u["ins"][0]),
              "deletes": len(u["dele"][0]), "removed": u["removed"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vids = eng.insert(*u["ins"])
    torch.cuda.synchronize()
    report["insert_ms"] = (time.perf_counter() - t0) * 1e3
    require(vids.tolist() == list(range(len(x), len(x) + len(vids))),
            "updates: insert vids")
    report["delta_cap"] = ex.index.delta_cap
    report["partitions_with_inserts"] = int((ex.index.delta_count > 0).sum())
    # capture every family's graphs on the inserted index (the insert
    # installed the delta buffers: a new shape epoch; a program captures
    # on its second call); the delete below keeps every shape, so the
    # calls after it replay these graphs on planes written in place
    se_insert = ex.index.shape_epoch
    for _ in range(2):
        for fn, _, _ in main_path.values():
            fn(eng)
    graphs = {"captured_before_delete": graph_count(ex),
              "shape_epoch_after_insert": se_insert}
    cap_ms = ex.compile_ms_total
    t0 = time.perf_counter()
    removed = eng.delete(*u["dele"])
    torch.cuda.synchronize()
    report["delete_ms"] = (time.perf_counter() - t0) * 1e3
    require(removed == u["removed"], f"updates: removed {removed}, "
            f"expected {u['removed']}")
    report["partitions_with_tombstones"] = int((ex.index.dead > 0).sum())
    require(plain.insert(*u["ins"]).tolist() == vids.tolist() and
            plain.delete(*u["dele"]) == removed, "updates: torch backend")
    log(f"[updates] {card}: insert {report['inserts']} points "
        f"{report['insert_ms']:.1f} ms (delta_cap {report['delta_cap']}, "
        f"{report['partitions_with_inserts']} partitions), delete "
        f"{report['deletes']} coordinates {report['delete_ms']:.1f} ms "
        f"(removed {removed}, {report['partitions_with_tombstones']} "
        "partitions)")

    def families(tag, against_plain):
        """Every family of the main path on the mutated engine, launch
        counts set to 0 just before and read just after; each call's
        wall (a call under a second: the median of three more, as the
        frozen index's were timed) and the calls' peak memory; then,
        ``against_plain``, each bitwise the torch backend's."""
        out, wall = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERN.reset_launch_counts()
        for name, (fn, _, _) in main_path.items():
            t0 = time.perf_counter()
            out[name] = fn(eng)
            torch.cuda.synchronize()
            wall[name] = (time.perf_counter() - t0) * 1e3
        got = KERN.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(all(got[n] > 0 for n in PATH_KERNELS),
                f"updates {tag}: launches {got}")
        for name, (fn, _, _) in main_path.items():
            if wall[name] < 1000:
                wall[name] = host_ms(lambda: fn(eng), 3, warm=False)
            if against_plain:
                require(same(out[name], fn(plain)),
                        f"updates {tag}: {name} cuda vs torch backend")
        log(f"[updates] {card}: {tag}, ms (frozen index in brackets): " +
            ", ".join(f"{n} {wall[n]:.1f} ({frozen_ms[n]:.1f})"
                      for n in wall) + f"; max_memory_allocated {peak}")
        return out, wall, got, peak

    pre, report["pre_refit_ms"], pre_launch, peak = families(
        "before the re-fit", True)
    graphs.update(shape_epoch_after_delete=ex.index.shape_epoch,
                  capture_ms_after_delete=ex.compile_ms_total - cap_ms,
                  graphs_after_delete=graph_count(ex))
    require(ex.index.shape_epoch == se_insert,
            "updates: the delete changed a shape")
    err = check_kernel_cases(kernel_cases(ex, *main_args))
    shape0 = (ex.index.n_pad, ex.index.probe, ex.index.knot_keys.shape[1])
    t0 = time.perf_counter()
    touched = eng.run(Refit())
    torch.cuda.synchronize()
    report["refit_ms"] = (time.perf_counter() - t0) * 1e3
    require(plain.run(Refit()) == touched, "updates: re-fit partitions")
    report.update(refit_partitions=len(touched), n_pad=[shape0[0],
                  ex.index.n_pad], probe=[shape0[1], ex.index.probe],
                  knot_width=[shape0[2], ex.index.knot_keys.shape[1]],
                  delta_cap_after_refit=ex.index.delta_cap,
                  epoch=ex.index.epoch, shape_epoch=ex.index.shape_epoch)
    log(f"[updates] {card}: re-fit {len(touched)} partitions "
        f"{report['refit_ms']:.1f} ms; n_pad {report['n_pad']}, probe "
        f"{report['probe']}, knot width {report['knot_width']}, delta_cap "
        f"{ex.index.delta_cap}, epoch {ex.index.epoch}, shape_epoch "
        f"{ex.index.shape_epoch}")
    post, report["post_refit_ms"], post_launch, peak2 = families(
        "after the re-fit", False)
    graphs.update(shape_epoch_after_refit=ex.index.shape_epoch,
                  graph_recaptures=ex.graph_recaptures,
                  graphs_after_refit=graph_count(ex))
    # a replay never found a moved plane: the delete and the re-fit wrote
    # the planes in place, and a shape change evicted the old programs
    require(ex.graph_recaptures == 0, f"updates: {ex.graph_recaptures} "
            "graphs captured again after a plane moved")
    require(all(k[5] == ex.index.shape_epoch for k in ex.cache_keys()),
            "updates: a program of a superseded shape epoch stayed")
    report["graphs"] = graphs
    log(f"[updates] graphs: {graphs}")
    report["max_memory_allocated"] = max(peak, peak2)
    err2 = check_kernel_cases(kernel_cases(ex, *main_args))
    report["kernel_max_abs_err"] = {n: max(err[n], err2[n]) for n in err}
    log(f"[updates] six kernels bitwise their plain versions on the "
        f"mutated and the re-fit index: {report['kernel_max_abs_err']}")

    # a fresh build of the surviving points, at the re-fit index's n_pad
    sx, sy, svid = u["surv"]
    t0 = time.perf_counter()
    fresh = SpatialEngine(build_index(sx, sy, part, vid=svid,
                                      n_pad=ex.index.n_pad, device=DEVICE),
                          device=DEVICE)
    fresh.executor.cuda_graphs = False
    torch.cuda.synchronize()
    report["fresh_build_s"] = time.perf_counter() - t0
    fresh.executor._sticky.update(sticky)
    for n in ("key", "x", "y", "vid", "count"):
        require(torch.equal(getattr(ex.index, n),
                            getattr(fresh.executor.index, n)),
                f"updates: re-fit {n} plane vs a fresh build")
    ties = {}
    for name, (fn, _, _) in main_path.items():
        want = fn(fresh)
        mat = name in ("range_query_256", "circle_query_256")
        for tag, got in (("before", pre), ("after", post)):
            ok, rows = same_as_fresh(got[name], want, mat)
            require(ok, f"updates: {name} {tag} the re-fit vs a fresh build")
            if rows:
                ties[f"{name} {tag}"] = rows
    require(not any(k.endswith("after") for k in ties),
            f"updates: kNN id order after the re-fit {ties}")
    report["knn_rows_reordered_in_ties"] = ties
    log("[updates] every family before and after the re-fit == a fresh "
        "build of the surviving points (counts, kNN d2 and id order "
        "bitwise, materialized ids as sets); kNN rows differing only in "
        f"tie order before the re-fit: {ties or 0}; re-fit planes == the "
        f"fresh build's; fresh build {report['fresh_build_s']:.1f} s")
    # the denormal delete on the main plane, now that the re-fit merged
    # (1e-45, 0.5) into it: a delete at x = 0.0 removes it
    pq = (np.float32([1e-45]), np.float32([0.5]))
    for e in (eng, plain):
        require(e.run(PointQuery(), *pq).tolist() == [True] and
                e.delete(np.float32([0.0]), np.float32([0.5])) == 1 and
                e.run(PointQuery(), *pq).tolist() == [False],
                "updates: the denormal delete on the main plane")
    release(ex)
    del eng, plain, fresh
    launches = {n: pre_launch[n] + post_launch[n] for n in pre_launch}

    # serving: an insert between rounds, a re-fit scheduled by it
    sess = SpatialServeSession(index, EngineConfig(
        delta_occupancy=UPD_SERVE_OCCUPANCY), device=DEVICE)
    sx_ = sess.executor
    sx_._sticky.update(serve_tiers)
    rounds = [serve_round(x, y, part, seed, dev) for seed in range(3)]
    sess.warmup(rounds[0])
    bx, by = ds.make("taxi", UPD_SERVE_INSERTS, seed=7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.insert(bx, by)
    torch.cuda.synchronize()
    srv = {"insert_ms": (time.perf_counter() - t0) * 1e3,
           "pending_refit": len(sess.stats()["pending_refit"])}
    require(srv["pending_refit"] > 0, "updates: no re-fit scheduled")
    srv["rounds"] = []
    for i in (1, 2):
        torch.cuda.synchronize()
        syncs = sx_.host_syncs
        KERN.reset_launch_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sess.submit_batch(rounds[i])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = KERN.launch_counts()
        require(sx_.host_syncs == syncs, f"updates: serving round {i} "
                "after an insert moved host_syncs")
        require(all(got[n] > 0 for n in PATH_KERNELS),
                f"updates: serving round {i} launches {got}")
        for n, c in got.items():
            launches[n] += c
        serve_checks(sx_, rounds[i], out, f"updates serving round {i}")
        row = {"round": i, "wall_ms": ms, "host_syncs_added": 0}
        if i == 1:
            t0 = time.perf_counter()
            moved = sess.maintain()
            torch.cuda.synchronize()
            row["maintain_ms"] = (time.perf_counter() - t0) * 1e3
            row["maintain_refit_partitions"] = len(moved.get("refit", []))
            require(moved.get("refit") and
                    not sess.stats()["pending_refit"],
                    f"updates: maintain() ran no re-fit ({moved})")
        srv["rounds"].append(row)
        log(f"[updates] {card}: serving round {i} at q = {SERVE_Q} after "
            f"an insert of {UPD_SERVE_INSERTS}: {ms:.1f} ms, host_syncs +0 "
            "(sync-debug \"error\")" + (
                f"; maintain() re-fit {row['maintain_refit_partitions']} "
                f"partitions in {row['maintain_ms']:.1f} ms, pending_refit "
                "empty" if i == 1 else ""))
    srv["stats"] = {k: (str(v) if k == "sticky" else v)
                    for k, v in sess.stats().items()}
    report["serving"] = srv
    release(sx_)
    del sess
    log(f"[updates] {card}: max_memory_allocated of the driven calls "
        f"{report['max_memory_allocated']}")
    return report, launches, report["kernel_max_abs_err"]


def closed_loop_clients(sched, reqs, n_clients, before=None):
    """``n_clients`` threads, client k sending requests k, k + n, ...
    one at a time, each waiting for its ticket (the serve launcher's
    clients). ``before``: started with the clients, run on a thread of
    its own (the launcher's insert stream). Returns (wall s, per request
    (submit time, latency us, ticket), in request order)."""
    import threading
    done = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            for i in range(k, len(reqs), n_clients):
                t0 = time.perf_counter()
                t = sched.submit(*reqs[i])
                t.result(300.0)
                done[i] = (t0, (time.perf_counter() - t0) * 1e6, t)
        except Exception as e:           # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    if before is not None:
        threads.append(threading.Thread(target=before))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
        require(not t.is_alive(), "scheduler: a client thread hung")
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, done


def scheduler_phase(index, part, x, y, card) -> tuple:
    """Phase 10: the streaming serve scheduler on ``index`` (see the
    module docstring). Returns (report, {kernel: launches of the
    scheduler's own dispatches})."""
    import torch
    from repro_torch import kernels as KERN
    from repro_torch.core.plan import EngineConfig, InsertBatch
    from repro_torch.launch.serve import insert_stream, scheduler_requests
    from repro_torch.serve import SpatialServeSession
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_gpu import maintain_syncs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    sess = SpatialServeSession(index, device=DEVICE)
    ex = sess.executor
    maint_syncs = maintain_syncs(ex)
    n_req = SCHED_BATCH * SCHED_ROUNDS
    reqs = scheduler_requests(x, y, part, n_req)
    kinds = ("point", "range_count", "knn10", "circle")
    t0 = time.perf_counter()
    sess.warmup(reqs[:4])
    torch.cuda.synchronize()
    report = {"card": card, "requests": n_req, "clients": SCHED_CLIENTS,
              "warmup_s": time.perf_counter() - t0,
              "tiers_after_warmup": {str(k): v
                                     for k, v in ex._sticky.items()}}
    launches = {n: 0 for n in KERN.KERNELS}

    # the serial replay: each request alone through session.submit. The
    # first 64 of each kind first; the rest only if the whole replay
    # stays within SCHED_SERIAL_S
    def replay(s, lo, hi):
        out = [s.submit(*r) for r in reqs[lo:hi]]
        # a device-wide sync fails while the worker captures: quiet first
        require(s.executor.precompile_quiesce(300.0),
                "scheduler: the precompile worker hung")
        torch.cuda.synchronize()
        return out

    # the precompile worker runs through this session's whole history,
    # the serial replay and the drain too, as a live server's would
    # (started by hand until (b)'s scheduler starts its own)
    require(ex.start_precompiler(), "scheduler: the precompile worker")
    st0 = ex.stats()
    t0 = time.perf_counter()
    serial = replay(sess, 0, 4 * 64)
    first_s = time.perf_counter() - t0
    if first_s * n_req / (4 * 64) <= SCHED_SERIAL_S:
        serial += replay(sess, 4 * 64, n_req)
    serial_s = time.perf_counter() - t0
    st1 = ex.stats()
    report["serial"] = {
        "replayed": len(serial), "wall_s": serial_s,
        "host_syncs_added": st1["host_syncs"] - st0["host_syncs"],
        "probe_syncs_added": st1["probe_syncs"] - st0["probe_syncs"]}
    log(f"[scheduler] {card}: serial replay of {len(serial)} of {n_req} "
        f"requests through session.submit in {serial_s:.1f} s "
        f"(host_syncs +{report['serial']['host_syncs_added']}, "
        f"probe_syncs +{report['serial']['probe_syncs_added']})")

    def check(tickets, what):
        for i, t in enumerate(tickets):
            require(t.done(), f"scheduler {what}: request {i} unresolved")
            got = t.result()
            if i < len(serial):
                require(same(got, serial[i]), f"scheduler {what}: request "
                        f"{i} ({kinds[i % 4]}) differs from serial")

    # (a) drain mode: everything queued, then one synchronous pump
    sched = sess.scheduler(start=False)
    tickets = [sched.submit(*r) for r in reqs]
    m0, st0 = maint_syncs[0], ex.stats()
    cap0 = dict(ex.capture_ms)
    KERN.reset_launch_counts()
    t0 = time.perf_counter()
    sched.drain()
    drain_s = time.perf_counter() - t0
    # the worker's backlog (the widths and tiers the drain handed over)
    require(ex.precompile_quiesce(300.0), "scheduler drain: the worker hung")
    quiet_s = time.perf_counter() - t0 - drain_s
    torch.cuda.synchronize()
    got = {n: c for n, c in KERN.launch_counts().items() if c}
    for n, c in got.items():
        launches[n] += c
    st1 = ex.stats()
    batches = [e for e in sched.events if e[0] == "batch"]
    require([(e[1], e[2], e[3]) for e in batches] ==
            [(k, n_req // 4, n_req // 4) for k in kinds],
            f"scheduler drain: batches {batches}")
    check(tickets, "drain")
    maint = maint_syncs[0] - m0
    report["drain"] = {
        "wall_s": drain_s, "events": [list(e) for e in sched.events],
        "launches": got,
        "host_syncs_added": st1["host_syncs"] - st0["host_syncs"],
        "host_syncs_added_by_maintain": maint,
        "probe_syncs_added": st1["probe_syncs"] - st0["probe_syncs"],
        "stats": sched.stats()}
    require(report["drain"]["host_syncs_added"] == maint,
            "scheduler drain: a dispatch read ok flags on the host")
    require(sched.stats()["maintain_busy"] == 0, "scheduler drain: busy")
    sched.close()
    ex.stop_precompiler()
    report["drain"].update(
        async_compiles=ex.async_compiles, worker_quiesce_s=quiet_s,
        capture_ms={k: ex.capture_ms[k] - cap0[k] for k in cap0},
        graphs=graph_count(ex), graph_pool_bytes=pool_bytes(ex))
    log(f"[scheduler] {card}: the precompile worker since warmup: "
        f"{ex.async_compiles} captures; after the drain it went quiet in "
        f"{quiet_s:.2f} s; capture ms in the drain serving "
        f"{report['drain']['capture_ms']['serving']:.1f} worker "
        f"{report['drain']['capture_ms']['worker']:.1f}; "
        f"{report['drain']['graphs']} graphs, pool "
        f"{report['drain']['graph_pool_bytes']} bytes")
    report["tiers_before_worker"] = {str(k): v
                                     for k, v in ex._sticky.items()}
    log(f"[scheduler] {card}: drain of {n_req} requests in {drain_s:.2f} s,"
        f" batches {[(e[1], e[2], e[3]) for e in batches]}, every ticket "
        f"bitwise serial; host_syncs +{report['drain']['host_syncs_added']}"
        f" (all {maint} of idle maintain()), probe_syncs "
        f"+{report['drain']['probe_syncs_added']}, launches {got}")

    def worker(sess, tally, what, with_inserts):
        """Worker mode: SCHED_CLIENTS closed-loop clients, and with
        ``with_inserts`` the launcher's two InsertBatch requests; the
        precompile worker runs when the session's config asks for it."""
        ex = sess.executor
        out = {}
        m0, st0 = tally[0], ex.stats()
        cap0 = dict(ex.capture_ms)
        torch.cuda.reset_peak_memory_stats()
        ins = []
        KERN.reset_launch_counts()
        with sess.scheduler() as sched:
            require(ex.precompiling == ex.cfg.serve_async_precompile,
                    f"scheduler {what}: precompile worker "
                    f"{ex.precompiling}")
            stream = None
            if with_inserts:
                bx, by = insert_stream(x, y, SCHED_BATCH)
                t = sched.submit(InsertBatch(), bx, by)
                t.result(300.0)                      # prewarm
                ins.append((time.perf_counter(), t))

                def stream():
                    t = sched.submit(InsertBatch(), bx, by)
                    t.result(300.0)
                    ins.append((time.perf_counter(), t))
            wall, done = closed_loop_clients(sched, reqs, SCHED_CLIENTS,
                                             stream)
            sched.drain()
            quiet = ex.precompile_quiesce(300.0)
        require(quiet, f"scheduler {what}: the precompile worker never "
                "went quiet")
        require(not ex.precompiling, f"scheduler {what}: close() left the "
                "precompile worker running")
        st = sched.stats()            # closed: idle maintenance counted
        events = list(sched.events)
        torch.cuda.synchronize()
        got = KERN.launch_counts()
        for n, c in got.items():
            launches[n] += c
        st1 = ex.stats()
        lat = np.asarray([d[1] for d in done])
        out.update(
            wall_s=wall, req_per_s=n_req / wall,
            p50_us=float(np.percentile(lat, 50)),
            p99_us=float(np.percentile(lat, 99)),
            max_us=float(lat.max()),
            mean_batch=st["mean_batch"], max_batch=st["max_batch"],
            read_batches=st["read_batches"],
            batch_widths=sorted({e[3] for e in events if e[0] == "batch"}),
            maintain_runs=st["maintain_runs"],
            maintain_busy=st["maintain_busy"],
            write_merges=st["write_merges"], writes=st["writes"],
            width_fallbacks=st["width_fallbacks"],
            async_compiles=st1["async_compiles"] - st0["async_compiles"],
            async_capture_errors=(st1["async_capture_errors"]
                                  - st0["async_capture_errors"]),
            capture_ms={k: ex.capture_ms[k] - cap0[k] for k in cap0},
            graphs=graph_count(ex), graph_pool_bytes=pool_bytes(ex),
            host_syncs_added=st1["host_syncs"] - st0["host_syncs"],
            host_syncs_added_by_maintain=tally[0] - m0,
            probe_syncs_added=st1["probe_syncs"] - st0["probe_syncs"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches={n: c for n, c in got.items() if c}, stats=st)
        require(st["maintain_busy"] == 0, f"scheduler {what}: busy")
        require(out["host_syncs_added"] == out["host_syncs_added_by_maintain"],
                f"scheduler {what}: a dispatch read ok flags on the host")
        require(out["async_capture_errors"] == 0,
                f"scheduler {what}: {out['async_capture_errors']} of the "
                "precompile worker's captures failed")
        if ex.cfg.serve_async_precompile:
            # no capture on the serving thread while the worker runs
            require(out["capture_ms"]["serving"] == 0.0,
                    f"scheduler {what}: the serving thread captured for "
                    f"{out['capture_ms']['serving']} ms")
        else:
            require(out["width_fallbacks"] == 0 == out["async_compiles"]
                    and out["capture_ms"]["worker"] == 0.0,
                    f"scheduler {what}: a handoff without the worker")
        tickets = [d[2] for d in done]
        if not with_inserts:
            check(tickets, what)
        else:
            require(len(ins) == 2, f"scheduler {what}: inserts {ins}")
            for resolved, t in ins:
                require(all(d[2].epoch >= t.epoch for d in done
                            if d[0] > resolved),
                        f"scheduler {what}: a read submitted after an "
                        "insert resolved saw an older epoch")
            out["insert_epochs"] = [t.epoch for _, t in ins]
            out["reads_after_an_insert"] = sum(d[0] > ins[-1][0]
                                               for d in done)
            for t in tickets:
                t.result()
        log(f"[scheduler] {card}: {what}: {n_req} requests from "
            f"{SCHED_CLIENTS} clients in {wall:.2f} s ({out['req_per_s']:.1f}"
            f" req/s), p50 {out['p50_us']:.0f} us, p99 {out['p99_us']:.0f} "
            f"us, max {out['max_us']:.0f} us, mean batch {st['mean_batch']},"
            f" max {st['max_batch']}, widths {out['batch_widths']}, "
            f"width_fallbacks {out['width_fallbacks']}, async_compiles "
            f"{out['async_compiles']}, worker capture failures "
            f"{out['async_capture_errors']}, capture ms serving "
            f"{out['capture_ms']['serving']:.1f} worker "
            f"{out['capture_ms']['worker']:.1f}, {out['graphs']} graphs, "
            f"graph pool {out['graph_pool_bytes']} bytes, maintain "
            f"{st['maintain_runs']} runs ({st['maintain_busy']} busy), "
            f"write_merges {st['write_merges']}, host_syncs "
            f"+{out['host_syncs_added']} (all of idle maintain()), "
            f"probe_syncs +{out['probe_syncs_added']}, max_memory_allocated"
            f" {out['max_memory_allocated']}, launches {out['launches']}")
        return out

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()    # warmup, replay, drain
    # (b) worker mode, reads only, with the precompile worker (the
    # default config): every ticket bitwise serial
    report["worker"] = worker(sess, maint_syncs, "worker", False)
    # (b) again on a session whose config keeps every capture on the
    # serving thread (serve_async_precompile=False), with the first
    # one's history: warmup, serial submits (two of each kind capture
    # width 1; no maintain() runs among them), the drain
    inline = SpatialServeSession(
        index, EngineConfig(serve_async_precompile=False), device=DEVICE)
    inline_syncs = maintain_syncs(inline.executor)
    inline.warmup(reqs[:4])
    replay(inline, 0, 8)
    isched = inline.scheduler(start=False)
    for r in reqs:
        isched.submit(*r)
    isched.drain()
    isched.close()
    torch.cuda.synchronize()
    report["tiers_before_worker_inline"] = {
        str(k): v for k, v in inline.executor._sticky.items()}
    report["worker_inline_captures"] = worker(
        inline, inline_syncs, "worker, no precompile worker", False)
    release(inline.executor)
    del inline
    # (c) worker mode with the insert stream, with the precompile worker:
    # read-your-writes epochs
    report["worker_inserts"] = worker(sess, maint_syncs, "worker + inserts",
                                      True)
    report["phase_s"] = time.perf_counter() - t_phase
    report["max_memory_allocated"] = max(
        peak, *(report[k]["max_memory_allocated"]
                for k in ("worker", "worker_inline_captures",
                          "worker_inserts")))
    del sess
    torch.cuda.empty_cache()
    require(all(launches[n] > 0 for n in SCHED_KERNELS),
            f"scheduler launches {launches}")
    log(f"[scheduler] {card}: phase {report['phase_s']:.1f} s, "
        f"max_memory_allocated {report['max_memory_allocated']}")
    return report, launches


def denormal_phase(dev) -> dict:
    """Phase 12: the four kernels that read float32 denormals as zero
    (range_count, circle_count, knn_topk, the join's point_in_polygon)
    on tests/test_torch_gpu.py's denormal points and queries (every pair
    active, whole rows), each against its plain version on the card and
    that against the plain version on the CPU, which the CPU tests hold
    bitwise to the JAX package. Returns {kernel: {max_abs_err, ...}}."""
    import torch
    from repro_torch.core import build_index, fit
    from repro_torch.core import local_ops as L
    from repro_torch.kernels import circle_filter as CF
    from repro_torch.kernels import knn_topk as KNN
    from repro_torch.kernels import point_in_polygon as PIP
    from repro_torch.kernels import range_filter as RF
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_gpu import denormal_points, denormal_queries
    x, y = denormal_points()
    idx = L.pad_partitions(build_index(
        x, y, fit("rtree", x, y, 9, sample_rate=0.05, seed=1),
        device="cpu"), 8)
    q = denormal_queries()
    c, nq = idx.x.shape[0], len(q["cx"])
    pg = len(q["ne"])
    s = np.zeros((c, nq), np.int32)
    e = np.broadcast_to(idx.count.numpy()[:, None], (c, nq)).astype(
        np.int32)
    act = np.ones((c, nq), bool)
    mbr = np.stack([q["cx"] - q["r"], q["cy"] - q["r"], q["cx"] + q["r"],
                    q["cy"] + q["r"]], -1).astype(np.float32)
    circ = np.stack([q["cx"], q["cy"], q["r"]], -1)
    jm = np.concatenate([q["polys"].min(1), q["polys"].max(1)], -1)
    calls = {
        "range_count": (RF.range_count, RF.range_count_plain, {},
                        (q["rects"], s, e, act, idx.count, idx.x, idx.y)),
        "circle_count": (CF.circle_count, CF.circle_count_plain, {},
                         (mbr, s, e, circ, act, idx.count, idx.x, idx.y)),
        "point_in_polygon": (PIP.join_count, PIP.join_count_plain, {},
                             (q["polys"], q["ne"], jm, s[:, :pg],
                              e[:, :pg], act[:, :pg], idx.count, idx.x,
                              idx.y)),
        "knn_topk": (KNN.knn_topk, KNN.knn_topk_plain, {"k": 6},
                     (q["qx"], q["qy"], idx.count, idx.x, idx.y))}

    def on(d, args):
        return [torch.as_tensor(np.asarray(a)).to(d) for a in args]

    out = {}
    for name, (fn, plain, kw, args) in calls.items():
        got, want = fn(*on(dev, args), **kw), plain(*on(dev, args), **kw)
        cpu = plain(*on("cpu", args), **kw)
        got, want, cpu = (v if isinstance(v, tuple) else (v,)
                          for v in (got, want, cpu))
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"denormals: {name} vs its plain version")
        require(all(torch.equal(w.cpu(), h) for w, h in zip(want, cpu)),
                f"denormals: {name}'s plain version, card vs CPU")
        out[name] = {"max_abs_err": err, "plain_equal_cpu": True,
                     "shape": list(got[0].shape)}
        log(f"[denormals] {name}: max_abs_err {err} against its plain "
            f"version on {out[name]['shape']}; plain on the card == on the "
            "CPU")
    return out


MESH_QSHARD_THRESHOLD = 256     # the 1,024- and 256-query batches shard


def mesh_phase(index, part, x, y, dev, main_path, res, lat, first_ms,
               tiers, eng) -> tuple:
    """Phase 11: the meshed engines at world size 1 (see the module
    docstring). Returns (report, {kernel: launches of the meshed calls
    and serving rounds})."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch import kernels as KERN
    from repro_torch.core import EngineConfig, SpatialEngine
    from repro_torch.launch import mesh as M
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_gpu import meshed_match
    t0 = time.perf_counter()
    store = Path(tempfile.mkdtemp()) / "store"
    rank_dev = M.init_process("cuda", init_method=f"file://{store}",
                              world_size=1, rank=0)
    require(dist.get_backend() == "nccl", "the mesh runs NCCL")
    engines = {
        "part": SpatialEngine(index, device=rank_dev, mesh=M.make_host_mesh(
            (1,), ("data",), device=rank_dev), part_axis="data"),
        "part_query": SpatialEngine(
            index, EngineConfig(query_shard_threshold=MESH_QSHARD_THRESHOLD),
            device=rank_dev, mesh=M.make_host_mesh(
                (1, 1), ("data", "query"), device=rank_dev),
            part_axis="data", query_axis="query"),
    }
    for e in engines.values():
        require(e.executor.cuda_graphs, "meshed programs as CUDA graphs")
    log("[mesh] world size 1, backend nccl; meshed programs run as CUDA "
        "graphs, their NCCL collectives captured with them")
    rep = {"graphs": True, "calls": {}, "qshard_threshold":
           MESH_QSHARD_THRESHOLD}
    # the unmeshed engine's launches per replay, taken before the counted
    # window: the mesh's counts are the meshed engines' alone
    unmeshed = {}
    for name, (fn, _, _) in main_path.items():
        if first_ms[name] <= 1000:
            k0 = KERN.launch_counts()
            fn(eng)
            torch.cuda.synchronize()
            k1 = KERN.launch_counts()
            unmeshed[name] = {n: k1[n] - k0[n] for n in k1 if k1[n] > k0[n]}
    KERN.reset_launch_counts()
    for name, (fn, _, base) in main_path.items():
        slow = first_ms[name] > 1000
        row = {"unmeshed_ms": lat[name]}
        if not slow:
            row["unmeshed_launches"] = unmeshed[name]
        for tag, e in engines.items():
            how = []
            for _ in range(3):      # eager, captured, replayed
                m0, k0 = M.launches, KERN.launch_counts()
                torch.cuda.synchronize()
                c0 = time.perf_counter()
                got = fn(e)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - c0) * 1e3
                how.append(meshed_match(got, res[name]))
            k1 = KERN.launch_counts()
            row[tag] = {"match": how, "nccl_per_call": M.launches - m0,
                        "timed": ("the third call (a replay)" if slow
                                  else "median of 3 more replays"),
                        "launches": {n: k1[n] - k0[n] for n in k1
                                     if k1[n] > k0[n]},
                        "ms": wall if slow else host_ms(lambda: fn(e), 3,
                                                        warm=False)}
            require(all(how), f"mesh {tag} {name}: {how}")
            if base is not None:
                # the strict call climbed from the initial tier, every
                # step on merged ok flags, to phase 5's tier
                row[tag]["tier"] = e.executor._sticky.get(base,
                                                          "exact fallback")
                require(row[tag]["tier"] == tiers[name],
                        f"mesh {tag} {name}: tier {row[tag]['tier']} vs "
                        f"unmeshed {tiers[name]}")
            require(row[tag]["nccl_per_call"] > 0,
                    f"mesh {tag} {name}: no collective")
            if not slow:
                require(row[tag]["launches"] == row["unmeshed_launches"],
                        f"mesh {tag} {name}: launches {row[tag]['launches']}"
                        f" vs unmeshed {row['unmeshed_launches']}")
        rep["calls"][name] = row
        log(f"[mesh] {name}: unmeshed {lat[name]:.3f} ms, " + ", ".join(
            f"{t} {row[t]['ms']:.3f} ms ({row[t]['match'][-1]}, "
            f"{row[t]['nccl_per_call']} NCCL, {row[t]['launches']}"
            + (f", tier {row[t]['tier']}" if base is not None else "")
            + ")" for t in engines))
    for tag, e in engines.items():
        ex = e.executor
        reqs = serve_round(x, y, part, 31, dev)
        ex.run_batch(reqs, strict=True)
        for _ in range(2):
            ex.run_batch(reqs)
        h, m0 = ex.host_syncs, M.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ex.run_batch(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rep[tag] = {"serving_host_syncs": ex.host_syncs - h,
                    "serving_nccl_per_round": M.launches - m0,
                    "qshard_executables": ex.stats()["qshard_executables"],
                    "graphs": graph_count(ex), "pool_bytes": pool_bytes(ex),
                    "cache_size": len(ex.cache_keys())}
        require(rep[tag]["serving_host_syncs"] == 0,
                f"mesh {tag}: a serving round synced the host")
        require(rep[tag]["graphs"] > 0, f"mesh {tag}: no CUDA graph")
        log(f"[mesh] {tag}: {json.dumps(rep[tag])}")
    require(rep["part"]["qshard_executables"] == 0 and
            rep["part_query"]["qshard_executables"] > 0,
            "qshard wrappings on the query mesh only")
    launched = KERN.launch_counts()
    release(*(e.executor for e in engines.values()))
    del engines
    dist.destroy_process_group()
    rep["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase {rep['seconds']:.1f} s; launches {launched}")
    return rep, launched


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch import kernels as KERN
    from repro_torch.core import EngineConfig, SpatialEngine, build_index
    from repro_torch.core import fit
    from repro_torch.core import keys as K
    from repro_torch.core import local_ops as L
    from repro_torch.data import spatial as ds
    from repro_torch.kernels import _build
    from repro_torch.kernels import circle_filter as CF
    from repro_torch.kernels import knn_topk as KNN
    from repro_torch.kernels import morton as MO
    from repro_torch.kernels import point_in_polygon as PIP
    from repro_torch.kernels import point_probe as PP
    from repro_torch.kernels import range_filter as RF
    from repro_torch.kernels import spline_search as SS

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    def phase(name):
        log(f"[phase] {name} at {time.perf_counter() - t_start:.1f} s "
            f"(in device_profile so far: {PROFILE_S[0]:.1f} s)")
    report = {}

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    report["card"] = card

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    require(set(libs) == {"spline_search", "range_filter", "point_probe",
                          "knn_topk", "circle_filter", "point_in_polygon",
                          "morton", "launch_floor"},
            f"kernel sources: {sorted(libs)}")
    log(f"[build] {len(libs)} sources in {report['build_s']:.1f} s")
    # ptxas -v: each instance's registers, stack and spills
    report["ptxas"] = {}
    for name in libs:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "Used" in ln or "spill" in ln
                 or "Function properties" in ln]
        report["ptxas"][name] = lines
        for line in lines:
            log(f"[build] {name}: {line}")

    phase("golden")
    # 3. golden replay with the CUDA kernels
    with open(ROOT / "tests" / "golden" / "spatial_golden.json") as f:
        golden = json.load(f)
    gx, gy, gpart, *gq = golden_inputs(ds, fit)
    geng = SpatialEngine(build_index(gx, gy, gpart, device=DEVICE),
                         EngineConfig(backend=BACKEND), device=DEVICE)
    got = replay_golden(geng, *gq)
    require(set(got) == set(golden), f"golden keys {sorted(golden)}")
    for key in golden:
        require(got[key] == golden[key], f"golden {key}")
    log(f"[golden] all {len(golden)} keys bitwise: {', '.join(golden)}")

    phase("index")
    # 4. full-size build on the card
    torch.cuda.reset_peak_memory_stats()
    x, y, part, index, report["data_s"], report["index_build_s"] = \
        full_index(dev)
    eng = SpatialEngine(index, device=DEVICE)
    ex = eng.executor
    require(eng.backend == BACKEND, "auto backend on the card")
    report.update(P=ex.index.num_partitions, n_pad=ex.index.n_pad,
                  probe=ex.index.probe,
                  m_eff=int(ex.index.knot_keys.shape[1]),
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"[index] taxi N={N_POINTS} kdtree {N_PARTS}: data "
        f"{report['data_s']:.1f} s, build {report['index_build_s']:.1f} s, "
        f"P={report['P']} n_pad={report['n_pad']} probe={report['probe']} "
        f"m_eff={report['m_eff']} max_memory_allocated="
        f"{report['max_memory_allocated']}")

    phase("main")
    # 5. the main path, once, with the launch counts around it
    (qx, qy, rects, kx, ky, rq_rects, cx, cy, cr, polys,
     ne) = main_inputs(x, y, part)
    k = 10

    def circle_exact(e):
        return e.executor._circle_exact(e.executor._circle_args((cx, cy, cr)))

    # name -> (call on an engine, kernels the call must launch, the
    # sticky key of an adaptive call's spec family)
    main_path = {
        "point_1024": (lambda e: e.point_query(qx, qy), {"point_probe"},
                       None),
        "range_count_1024": (lambda e: e.range_count(rects),
                             {"spline_search", "range_count"}, None),
        "knn10_exact_256": (lambda e: e.knn(kx, ky, k, "exact"),
                            {"knn_topk"}, None),
        "range_query_256": (lambda e: e.range_query(rq_rects), set(),
                            ("range",)),
        "circle_count_256": (lambda e: e.circle_count(cx, cy, cr), set(),
                             ("circle", False)),
        "circle_query_256": (lambda e: e.circle_query(cx, cy, cr), set(),
                             ("circle", True)),
        "circle_exact_256": (circle_exact,
                             {"spline_search", "circle_count"}, None),
        "knn10_pruned_256": (lambda e: e.knn(kx, ky, k), set(),
                             ("knn", k)),
        "join_windowed_32": (lambda e: e.join_count(polys, ne), set(),
                             ("join",)),
        "join_full_32": (lambda e: e.join_count(polys, ne, mode="full"),
                         {"spline_search", "point_in_polygon"}, None),
    }
    res, first_ms, peak, path_launches, tiers = {}, {}, {}, {}, {}
    KERN.reset_launch_counts()
    for name, (fn, needs, base) in main_path.items():
        before = KERN.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res[name] = fn(eng)
        torch.cuda.synchronize()
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        peak[name] = torch.cuda.max_memory_allocated()
        after = KERN.launch_counts()
        path_launches[name] = {n: after[n] - before[n] for n in after
                               if after[n] > before[n]}
        require(all(n in path_launches[name] for n in needs),
                f"{name} launched {path_launches[name]}, needs {needs}")
        # each family's first call on this engine: with no sticky tier
        # after it, the ladder maxed out and the exact fallback answered
        tiers[name] = None if base is None else ex._sticky.get(
            base, "exact fallback")
        log(f"[main] {name}: first call {first_ms[name]:.1f} ms, tier "
            f"{tiers[name]}, launches {path_launches[name]}, "
            f"max_memory_allocated {peak[name]}")
    require(path_launches["point_1024"] == {"point_probe": 1},
            f"point_1024 launched {path_launches['point_1024']}")
    launches = KERN.launch_counts()
    log(f"[main] launches {launches}")
    # every kernel but morton, whose only entry point is its own (phase 12)
    require(all(launches[n] > 0 for n in PATH_KERNELS),
            f"a kernel of the main path never launched: {launches}")
    report.update(first_call_ms=first_ms, max_memory_allocated_per_call=peak,
                  path_launches=path_launches, tiers=tiers)

    found = res["point_1024"]
    counts = res["range_count_1024"]
    d2, vid = res["knn10_exact_256"]
    require(found.shape == (1024,) and found.dtype == torch.bool, "point")
    require(counts.shape == (1024,) and counts.dtype == torch.int32, "rc")
    require(d2.shape == (256, k) and bool(torch.isfinite(d2).all()), "knn")
    require(bool(found[:512].all()), "every data point is found")
    plain = SpatialEngine(index, EngineConfig(backend="torch"),
                          device=DEVICE)
    plain.executor.cuda_graphs = False      # the reference: eager
    for name, (fn, _, _) in main_path.items():
        # the first call ran eagerly; by the third, every program it
        # runs was captured (on its second call) and replays
        for _ in range(2):
            require(same(res[name], fn(eng)), f"{name}: graph replay vs "
                    "the eager first call")
        require(same(res[name], fn(plain)), f"{name}: cuda vs torch backend")
    report["graphs_after_main"] = graph_count(ex)
    oracle_checks(x, y, qx, qy, rects, kx, ky, found.cpu().numpy(),
                  counts.cpu().numpy(), d2.cpu().numpy(), vid.cpu().numpy(),
                  k)
    require(torch.equal(res["join_windowed_32"], res["join_full_32"]),
            "join windowed == full")
    require(torch.equal(res["knn10_pruned_256"][0], d2),
            "pruned kNN d2 == exact kNN d2")
    ccount = res["circle_count_256"]
    require(torch.equal(ccount, res["circle_exact_256"]),
            "circle_count == the exact circle program")
    require(torch.equal(res["circle_query_256"][0], ccount),
            "circle_query counts == circle_count")
    rq_cnt, rq_vids, rq_ok = (a.cpu().numpy() for a in res["range_query_256"])
    order = np.argsort(x, kind="stable")
    xs = x[order]
    for i in np.flatnonzero(rq_ok):
        want = range_oracle_ids(x, y, order, xs, rq_rects[i])
        got_ids = np.sort(rq_vids[i][rq_vids[i] >= 0])
        require(np.array_equal(got_ids, want) and rq_cnt[i] == len(want),
                f"range query {i} vs numpy brute force")
    log("[main] cuda == torch backend bitwise on every call; numpy oracle "
        f"agrees on 64 queries each and on {int(rq_ok.sum())} of 256 range "
        f"queries (those ok); join windowed == full; pruned == exact d2; "
        f"circle_count == exact program; mean range count "
        f"{float(counts.float().mean()):.1f}, mean circle count "
        f"{float(ccount.float().mean()):.1f}, join counts "
        f"{res['join_full_32'].tolist()}")

    # the same calls on an engine running every program eagerly (its
    # sticky tiers preset): each call's wall beside the graphs', and the
    # busy time of the calls under a second (a slow call is device-bound
    # and launches the same kernels: its busy time is the graph's)
    eager = SpatialEngine(index, device=DEVICE)
    eager.executor.cuda_graphs = False
    eager.executor._sticky.update(ex._sticky)
    lat, lat_plain, lat_eager, busy_eager = {}, {}, {}, {}
    report["where"] = {}
    for name, (fn, _, _) in main_path.items():
        # a slow call was warmed by its first call and the bitwise check
        slow = first_ms[name] > 1000
        lat[name] = host_ms(lambda: fn(eng), 1 if slow else 5,
                            warm=not slow)
        lat_plain[name] = host_ms(lambda: fn(plain), 1 if slow else 3,
                                  warm=not slow)
        lat_eager[name] = host_ms(lambda: fn(eager), 1 if slow else 5,
                                  warm=not slow)
        busy_eager[name] = None if slow else sum(device_profile(
            lambda: fn(eager), 3, warm=False).values())
        acts: dict = {}
        prof, kept = traced(lambda: fn(eng), 1 if slow else 3, acts,
                            warm=not slow)
        busy = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
        report["where"][name] = {"device_busy_ms": busy,
                                 "idle_share": 1.0 - busy / lat[name],
                                 "trace_retention": kept,
                                 "activities_per_call": sum(acts.values()),
                                 "top_device_ms": top}
        if name == "point_1024":
            report["where"][name]["activities"] = acts
            log(f"[where] point_1024 activities per call: {acts}")
        log(f"[latency] {name}: cuda {lat[name]:.3f} ms (device busy "
            f"{busy:.3f} ms, idle share {1.0 - busy / lat[name]:.3f}, "
            f"trace retention {kept}), eager {lat_eager[name]:.3f} ms "
            f"(busy {busy_eager[name]}), torch backend (eager) "
            f"{lat_plain[name]:.3f} ms")
        log(f"[where] {name}: " + "; ".join(f"{n} {t:.4f}" for n, t in top))
    report["batch_ms"] = lat
    report["batch_ms_torch_backend"] = lat_plain
    report["batch_ms_eager"] = lat_eager
    report["device_busy_ms_eager"] = busy_eager
    release(eager.executor)
    del eager

    # the row-chunk budget (EngineConfig.scan_chunk_elems): circle_count
    # at its sticky tier under the default budget and under twice it, on
    # a second engine given the same sticky tier (the budget moves no ok
    # flag, so its own ladder settles there too). The counts must not
    # change; peak memory and latency do.
    def row_budget(budget):
        # an eager engine (a replay allocates nothing new) at the sticky
        # tier of phase 5's circle count
        e = SpatialEngine(index, EngineConfig(scan_chunk_elems=budget),
                          device=DEVICE)
        e.executor.cuda_graphs = False
        e.executor._sticky[("circle", False)] = ex._sticky[("circle",
                                                            False)]
        fn = main_path["circle_count_256"][0]
        tier = e.executor._sticky[("circle", False)]
        prog = L._CircleWindowLocal(e.executor.index, e.executor.cfg,
                                    e.executor.backend, *tier, False)
        plane = min(tier[1], prog.p_total) * 4 * (prog.cap +
                                                  prog.lookup_elems)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        require(torch.equal(fn(e), ccount), f"circle_count at {budget}")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mem = torch.cuda.max_memory_allocated()
        busy = sum(device_profile(lambda: fn(e), 1, warm=False).values())
        return {"scan_chunk_elems": budget, "tier": tier,
                "rows_per_chunk": max(1, budget // plane),
                "max_memory_allocated": mem, "wall_ms": ms,
                "device_busy_ms": busy, "idle_share": 1.0 - busy / ms}

    report["row_budget"] = [row_budget(ex.cfg.scan_chunk_elems),
                            row_budget(2 * ex.cfg.scan_chunk_elems)]
    release()           # the eager engines' blocks go back to the card
    for rb in report["row_budget"]:
        log(f"[budget] circle_count_256 at scan_chunk_elems "
            f"{rb['scan_chunk_elems']}: tier {rb['tier']}, "
            f"{rb['rows_per_chunk']} rows per call, max_memory_allocated "
            f"{rb['max_memory_allocated']}, {rb['wall_ms']:.3f} ms (device "
            f"busy {rb['device_busy_ms']:.3f} ms, idle share "
            f"{rb['idle_share']:.3f})")

    phase("serve")
    # 6. serving mode on the same index
    (report["serve"], serve_launches, serve_tiers, serve_sess,
     serve_plain) = serve_phase(index, part, x, y, dev)
    require(all(serve_launches[n] > 0 for n in PATH_KERNELS),
            f"serve launches {serve_launches}")

    phase("warm")
    # 7. warm start: graphs, the kernel store, manifest and restart
    report["warm"] = warm_phase(
        eng, plain, main_path,
        (rects, qx, qy, kx, ky, (cx, cy, cr), polys, ne), serve_sess, x, y,
        part, dev, card)
    report["warm"]["families"] = {
        n: {"graph_ms": lat[n], "graph_busy_ms":
            report["where"][n]["device_busy_ms"],
            "eager_ms": report["batch_ms_eager"][n],
            "eager_busy_ms": report["device_busy_ms_eager"][n],
            "torch_backend_eager_ms": report["batch_ms_torch_backend"][n]}
        for n in main_path}
    log("[warm] (b) per family, graphs / eager ms (busy): " + "; ".join(
        f"{n} {v['graph_ms']:.3f} ({v['graph_busy_ms']:.3f}) / "
        f"{v['eager_ms']:.3f} ({v['eager_busy_ms']})"
        for n, v in report["warm"]["families"].items()))
    release(plain.executor)
    del serve_sess, serve_plain, plain

    phase("wide")
    # 8. serving mode at the reference's default batch: bucketed
    report["serve_wide"], wide_launches = wide_serve_phase(index, part, x,
                                                           y, dev)
    require(all(wide_launches[n] > 0 for n in PATH_KERNELS),
            f"wide serve launches {wide_launches}")
    peaks = {q: max(r["max_memory_allocated"] for r in report[k]["rounds"])
             for q, k in ((SERVE_Q, "serve"), (WIDE_Q, "serve_wide"))}
    report["serve_peak_memory_by_q"] = peaks
    log(f"[wide] peak memory of a steady round by q: {peaks}")

    phase("updates")
    # 9. the update path on the full index
    report["updates"], upd_launches, upd_err = update_phase(
        index, part, x, y, dev, main_path,
        (rects, qx, qy, kx, ky, (cx, cy, cr), polys, ne), dict(ex._sticky),
        serve_tiers, lat, card)
    require(all(upd_launches[n] > 0 for n in PATH_KERNELS),
            f"update launches {upd_launches}")

    phase("scheduler")
    # 10. the streaming serve scheduler on a session of its own
    report["scheduler"], sched_launches = scheduler_phase(index, part, x, y,
                                                          card)

    phase("mesh")
    # 11. the meshed engines at world size 1 (NCCL)
    release(ex)
    report["mesh"], mesh_launches = mesh_phase(
        index, part, x, y, dev, main_path, res, lat, first_ms, tiers, eng)
    require(all(mesh_launches[n] > 0 for n in PATH_KERNELS),
            f"mesh launches {mesh_launches}")

    phase("kernels")
    # 12. each kernel against its plain version on the inputs the main
    # path gives it: every launch of one call (one per partition chunk,
    # or one per candidate set) is held bitwise against the plain
    # version, and the times, bytes and operations are those of the
    # whole call
    parts, kw = ex.parts, dict(radix_bits=ex.index.radix_bits,
                               probe=ex.index.probe)
    probe = ex.index.probe
    c = ex.cfg.part_chunk
    p_total, n_pad = parts["keys_f"].shape
    rect_t = torch.as_tensor(rects, device=dev)
    klo, khi = (K.keys_to_f32(v) for v in K.rect_key_range(rect_t, ex.spec))
    q2 = torch.cat([klo, khi + 1.0]).contiguous()
    chunks = list(L._chunks(parts, c))
    rows = []

    def sweep(fn, arglist, **kws):
        return lambda: [fn(*a, **kws) for a in arglist]

    by_path = {"main": launches, "serve": serve_launches,
               "serve_wide": wide_launches, "updates": upd_launches,
               "scheduler": sched_launches, "mesh": mesh_launches}

    def launch_floor(n, blocks, threads) -> dict:
        """The card's floor per launch: an empty kernel
        (csrc/launch_floor.cu, on no query path) timed as the kernels
        are, ms per launch over 17 launches back to back, of one block
        of 32 threads and of ``blocks`` blocks of ``threads`` threads,
        and ms for ``n`` such launches (a main-path call's)."""
        from repro_torch.kernels._args import I, P, stream
        lib = _build.load("launch_floor", {"empty_launch": [I, I, P]})

        def empty(k, b, th):
            def go():
                for _ in range(k):
                    _build.check(lib, "empty_launch",
                                 lib.empty_launch(b, th, stream()))
            return go
        out = {"one_block_ms_per_launch":
               stream_ms(empty(17, 1, 32), 20) / 17,
               "grid": [blocks, threads],
               "ms_per_launch": stream_ms(empty(17, blocks, threads), 20) / 17,
               "launches_per_call": n,
               "ms_per_call": stream_ms(empty(n, blocks, threads), 20)}
        log(f"[floor] empty kernel: {out}")
        return out

    def interval_extra(name, fn, plain, args, lib, call, narrow, sq,
                       first=1):
        """The interval scan's instances' own fields: one launch per
        chunk on the main path, the grid, the spread of the intervals
        (s and e at ``first`` and ``first + 1`` in a launch's arguments,
        active and count fourth and third from the end), each chunk's
        device time, ptxas' registers (no stack, no spills), and the
        time of ``narrow``, the serving fallback's launches of ``sq``
        queries on the same chunks, each bitwise too."""
        per_call = path_launches[call][name]
        require(per_call == len(chunks),
                f"{name}: {per_call} launches per call, {len(chunks)} chunks")
        ptx = ptxas_summary(report["ptxas"][lib])
        require(ptx["registers"] and not any(
            ptx["stack"] + ptx["spill_stores"] + ptx["spill_loads"]),
            f"{lib}: stack or spills {ptx}")
        spread = interval_spread([(a[first], a[first + 1], a[-4], a[-3],
                                   n_pad) for a in args])
        log(f"[{name}] grid {RF.grid(dev)}, intervals p50 {spread['p50']} "
            f"p90 {spread['p90']} p99 {spread['p99']} max {spread['max']}, "
            f"ptxas {ptx}")
        for a in narrow:
            require(torch.equal(fn(*a), plain(*a)),
                    f"{name} vs plain at the serving shape")
        serve_ms = stream_ms(sweep(fn, narrow), 20)
        return {"launches_per_call": per_call, "grid": RF.grid(dev),
                "spread": spread, "ptxas": ptx,
                "per_chunk_ms": [stream_ms(lambda a=a: fn(*a), 20)
                                 for a in args],
                "serve_shape_q": sq, "serve_shape_ms": serve_ms,
                "serve_shape_ms_per_launch": serve_ms / len(narrow)}

    def entry(name, err, t, pt, nbytes, nops, lt, call, peak_ops=PEAK_F32,
              extra=None):
        """One kernel row; ``call`` is the path's call whose launches
        were timed (``launches`` counts every path's); ``extra``, more
        fields for the row."""
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = nops / peak_ops * 1e3
        per_call = path_launches[call][name]
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": sum(paths.values()),
               "launches_by_path": paths,
               "max_abs_err": err, "ms": t["ms"], "plain_ms": pt["ms"],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lt is None else lt["ms"],
               "timed_call": call, "timed_call_launches": per_call,
               "ms_per_launch": t["ms"] / per_call,
               "ms_source": t["source"], "wall_ms": t["wall_ms"],
               "trace_ms_per_activity": t["trace_ms_per_activity"],
               "trace_events_per_call": t["trace_events_per_call"],
               "ms_cold_l2": t.get("cold_ms"),
               "plain_wall_ms": pt["wall_ms"], "bytes": nbytes, "ops": nops,
               **(extra or {})}
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")

    # spline_search: both ends of every rect against every chunk. Bytes:
    # the keys, the model rows, the union of the probe windows, the output.
    ss_args = [(q2, ch["knot_keys"], ch["knot_pos"], ch["radix_table"],
                ch["keys_f"], ch["radix_kmin"], ch["radix_scale"],
                ch["n_knots"], ch["count"]) for _, ch in chunks]
    err = 0
    for a in ss_args:
        err = max(err, int((SS.spline_search(*a, **kw) -
                            SS.spline_search_plain(*a, **kw)).abs().max()))
    # torch.searchsorted on the padded rows is the same function: a row
    # pads with 3e38 past its count, so the first index with a key >= q
    # is at most the count for these keys. Held equal on every chunk.
    ss_lib = [(ch["keys_f"], q2[None, :].expand(ch["keys_f"].shape[0], -1)
               .contiguous()) for _, ch in chunks]
    for a, la in zip(ss_args, ss_lib):
        require(torch.equal(SS.spline_search(*a, **kw),
                            torch.searchsorted(*la).to(torch.int32)),
                "spline_search vs torch.searchsorted")
    # the floor that one launch per chunk puts on a call: as many
    # one-element PyTorch kernels, back to back
    one = torch.zeros(1, device=dev)
    floor_ms = stream_ms(lambda: [one.add_(1) for _ in ss_args], 20)
    t = timed(sweep(SS.spline_search, ss_args, **kw), 50,
              "spline_search_kernel")
    pt = timed(sweep(SS.spline_search_plain, ss_args, **kw), 3)
    lt = timed(sweep(torch.searchsorted, ss_lib), 20)
    st = SS.window_start(q2, parts["knot_keys"], parts["knot_pos"],
                         parts["radix_table"], n_pad, parts["radix_kmin"],
                         parts["radix_scale"], parts["n_knots"], **kw)
    m, r = parts["knot_keys"].shape[1], parts["radix_table"].shape[1]
    nq2 = q2.shape[0]
    nbytes = 4 * (nq2 * len(chunks) + p_total * (2 * m + r + 4) +
                  covered(st, st + probe, n_pad) + p_total * nq2)
    entry("spline_search", err, t, pt, nbytes,
          p_total * nq2 * (probe + 16), lt, "range_count_1024",
          extra={"library_equal": True, "launch_floor_ms": floor_ms})

    # range_count: every chunk. Bytes: the rects, bounds and flags, x and
    # y over the union of the active [s, min(e, count)) intervals, the
    # output.
    rc_args = count_launch_args(ex, rect_t, klo, khi)
    err = 0
    for a in rc_args:
        err = max(err, int((RF.range_count(*a) -
                            RF.range_count_plain(*a)).abs().max()))
    t = timed(sweep(RF.range_count, rc_args), 50, RANGE_TRACE)
    pt = timed(sweep(RF.range_count_plain, rc_args), 2)
    s_all, hi_all = interval_ends(rc_args)
    pairs = int((hi_all - s_all).clamp(min=0).sum())
    nq = rect_t.shape[0]
    nbytes = (16 * nq * len(chunks) + 9 * p_total * nq + 4 * p_total +
              8 * covered(s_all, hi_all, n_pad) + 4 * p_total * nq)
    entry("range_count", err, t, pt, nbytes, 4 * pairs, None,
          "range_count_1024", extra=interval_extra(
              "range_count", RF.range_count, RF.range_count_plain,
              rc_args, "range_filter", "range_count_1024",
              [first_queries(a, SERVE_Q) for a in rc_args], SERVE_Q))

    # point_probe, the fused point query: the main path's call, one
    # launch, held bitwise on two launches in a row. Bytes (each input
    # read once): the queries, the grid boxes, the knot-key rows of the
    # candidate partitions and their two knot positions per (query,
    # candidate), the keys over the union of the lookup and probe
    # windows, x and y where a probe-window key equals the query's, the
    # output; also the bytes of two knot rows and two windows per query.
    ov = ex.index.overflow
    qxt = torch.as_tensor(qx, device=dev)
    qyt = torch.as_tensor(qy, device=dev)
    qk = K.keys_to_f32(K.make_keys(qxt, qyt, ex.spec))
    kk, kp, keys_f = parts["knot_keys"], parts["knot_pos"], parts["keys_f"]
    pq_args = (ex.bounds, kk, kp, keys_f, parts["x"], parts["y"],
               parts["count"], qxt, qyt, qk)
    pq_kw = dict(overflow=ov, probe=probe)
    want = PP.point_query_plain(*pq_args, **pq_kw)
    require(torch.equal(want, res["point_1024"].to(torch.int32)),
            "point_query_plain vs the main path's point call")
    err = 0
    for _ in range(2):
        got = PP.point_query(*pq_args, **pq_kw)
        require(torch.equal(got, want), "point_query vs plain")
        err = max(err, int((got - want).abs().max()))
    t = timed(lambda: PP.point_query(*pq_args, **pq_kw), 100, POINT_TRACE)
    pt = timed(lambda: PP.point_query_plain(*pq_args, **pq_kw), 10)
    # a meshed rank's launch: the upper half of the partitions as its
    # shard (part_offset > 0; at world size 1 the offset is always 0)
    off = p_total // 2
    sh_args = (ex.bounds, *(a[off:].contiguous() for a in pq_args[1:7]),
               qxt, qyt, qk)
    sh_kw = dict(pq_kw, part_offset=off)
    sh_want = PP.point_query_plain(*sh_args, **sh_kw)
    sh_got = PP.point_query(*sh_args, **sh_kw)
    require(torch.equal(sh_got, sh_want),
            "point_query on a shard vs plain with the same offset")
    sh_t = timed(lambda: PP.point_query(*sh_args, **sh_kw), 100,
                 POINT_TRACE)
    shard = {"part_offset": off, "p_loc": p_total - off,
             "max_abs_err": int((sh_got - sh_want).abs().max()),
             "found": int(sh_got.sum()), "ms": sh_t["ms"]}
    log(f"[point_probe] shard launch: {json.dumps(shard)}")
    nq, m = qk.shape[0], kk.shape[1]
    pid1 = PP.first_box(ex.bounds, qxt, qyt, ov)
    pids = torch.cat([pid1, torch.full_like(pid1, ov)])
    qk2 = torch.cat([qk, qk])
    # the lookup window's start, from lower_bound_plain's own steps
    krow, prow = kk[pids], kp[pids]
    seg = ((krow < qk2[:, None]).sum(1, keepdim=True) - 1).clamp(0, m - 2)
    phat = SS.interpolate(qk2[:, None], krow.gather(1, seg),
                          krow.gather(1, seg + 1), prow.gather(1, seg),
                          prow.gather(1, seg + 1))[:, 0]
    start = (torch.round(phat).to(torch.int64) - probe // 2).clamp(
        0, n_pad - probe)
    pos = PP.lower_bound_plain(kk, kp, keys_f, parts["count"], pids, qk2,
                               probe=probe)
    s2 = (pos - probe // 2).clamp(0, n_pad - probe)
    lo = (torch.cat([start, s2]) + torch.cat([pids, pids]) * n_pad)[None]
    cols = s2[:, None] + torch.arange(probe, device=dev)
    eq = keys_f[pids[:, None], cols] == qk2[:, None]
    xy_at = torch.unique((pids[:, None] * n_pad + cols)[eq]).numel()
    nbytes = (12 * nq + 16 * ov + 4 * m * torch.unique(pids).numel() +
              8 * torch.unique(pids * m + seg[:, 0]).numel() +
              4 * covered(lo, lo + probe, p_total * n_pad) + 8 * xy_at +
              4 * nq)
    rows_windows = 12 * nq + 16 * ov + 2 * nq * 4 * (m + probe) + 4 * nq
    # operations: the box tests up to each point's first box, the knot
    # row's and both windows' compares, about ten for the interpolation
    nops = (4 * int((pid1 + 1).clamp(max=ov).sum()) +
            2 * nq * (m + 2 * probe + 10))
    blocks = -(-2 * nq * 32 // 256)     # a warp per (query, candidate)
    ptx = ptxas_summary(report["ptxas"]["point_probe"])
    entry("point_probe", err, t, pt, nbytes, nops, None, "point_1024",
          extra={"grid": [blocks, 256], "ptxas": ptx, "shard": shard,
                 "bound_ms_two_rows_two_windows_per_query":
                     rows_windows / PEAK_BYTES * 1e3,
                 "launch_floor": launch_floor(1, blocks, 256)})

    # knn_topk: every chunk. Bytes: the queries, x and y of the valid
    # points, the outputs.
    kxt = torch.as_tensor(kx, device=dev)
    kyt = torch.as_tensor(ky, device=dev)
    kn_args = [(kxt, kyt, ch["count"], ch["x"], ch["y"]) for _, ch in chunks]
    err = 0.0
    for a in kn_args:
        an, ai = KNN.knn_topk(*a, k=k)
        bn, bi = KNN.knn_topk_plain(*a, k=k)
        require(torch.equal(ai, bi), "knn_topk ids vs plain")
        err = max(err, float((an - bn).abs().max()))
    t = timed(sweep(KNN.knn_topk, kn_args, k=k), 5, "knn_topk_kernel")
    pt = timed(sweep(KNN.knn_topk_plain, kn_args, k=k), 1)
    nq = kxt.shape[0]
    npts = int(parts["count"].sum())
    # the serving fallback's shape: SERVE_Q queries on the same chunks,
    # each launch bitwise too
    kn_serve = [(kxt[:SERVE_Q].contiguous(), kyt[:SERVE_Q].contiguous(),
                 *a[2:]) for a in kn_args]
    for a in kn_serve:
        an, ai = KNN.knn_topk(*a, k=k)
        bn, bi = KNN.knn_topk_plain(*a, k=k)
        require(torch.equal(ai, bi) and torch.equal(an, bn),
                "knn_topk vs plain at the serving shape")
    ts = timed(sweep(KNN.knn_topk, kn_serve, k=k), 20, "knn_topk_kernel")
    entry("knn_topk", err, t, pt,
          8 * npts + 8 * nq * len(chunks) + 8 * p_total * nq * k,
          5 * nq * npts, None, "knn10_exact_256", extra={
              "plan": KNN.plan(nq, n_pad, c, k, dev),
              "serve_shape_q": SERVE_Q, "serve_shape_ms": ts["ms"],
              "serve_shape_ms_per_launch": ts["ms"] / len(kn_serve),
              "serve_shape_plan": KNN.plan(SERVE_Q, n_pad, c, k, dev),
              "serve_shape_bound_ms": max(
                  (8 * npts + 8 * SERVE_Q * len(chunks) +
                   8 * p_total * SERVE_Q * k) / PEAK_BYTES,
                  5 * SERVE_Q * npts / PEAK_F32) * 1e3})

    # circle_count: the exact circle program's chunks. Bytes: the MBRs and
    # circles, bounds and flags, x and y over the union of the active
    # [s, min(e, count)) intervals, the output; about ten operations per
    # scanned position.
    crect, cklo, ckhi, ccirc = ex._circle_args((cx, cy, cr))
    cc_args = count_launch_args(ex, crect, cklo, ckhi, ccirc)
    err = 0
    for a in cc_args:
        err = max(err, int((CF.circle_count(*a) -
                            CF.circle_count_plain(*a)).abs().max()))
    t = timed(sweep(CF.circle_count, cc_args), 20, CIRCLE_TRACE)
    pt = timed(sweep(CF.circle_count_plain, cc_args), 1)
    s_all, hi_all = interval_ends(cc_args)
    pairs = int((hi_all - s_all).clamp(min=0).sum())
    nq = crect.shape[0]
    nbytes = (28 * nq * len(chunks) + 9 * p_total * nq + 4 * p_total +
              8 * covered(s_all, hi_all, n_pad) + 4 * p_total * nq)
    entry("circle_count", err, t, pt, nbytes, 10 * pairs, None,
          "circle_exact_256", extra=interval_extra(
              "circle_count", CF.circle_count, CF.circle_count_plain,
              cc_args, "circle_filter", "circle_exact_256",
              [first_queries(a, SERVE_Q) for a in cc_args], SERVE_Q))

    # point_in_polygon (the fused join count): the full join's chunks.
    # Bytes: the polygons, MBRs, bounds and flags, x and y over the union
    # of the active intervals, the output; operations: about 8 per edge
    # per scanned point inside the polygon's MBR (n_edges of them, as
    # the kernel loops over min(n_edges, E) <= n_edges).
    jc_args = join_launch_args(ex, polys, ne)
    in_mbr_edges = 0
    for jpoly, jne, jmbrs, s, e, act, count, cx_, cy_ in jc_args:
        in_mbr = RF.range_mask(jmbrs, s, e, count, cx_, cy_,
                               act).sum(-1)                   # (C, PG)
        in_mbr_edges += int((in_mbr * jne[None, :]).sum())
    err = 0
    for a in jc_args:
        err = max(err, int((PIP.join_count(*a) -
                            PIP.join_count_plain(*a)).abs().max()))
    t = timed(sweep(PIP.join_count, jc_args), 20, POLYGON_TRACE)
    pt = timed(sweep(PIP.join_count_plain, jc_args), 1)
    s_all, hi_all = interval_ends(jc_args, first=3)
    npg, e_max = jpoly.shape[0], jpoly.shape[1]
    nbytes = ((8 * e_max + 20) * npg * len(chunks) + 9 * p_total * npg +
              4 * p_total + 8 * covered(s_all, hi_all, n_pad) +
              4 * p_total * npg)
    entry("point_in_polygon", err, t, pt, nbytes, 8 * in_mbr_edges, None,
          "join_full_32", extra=interval_extra(
              "point_in_polygon", PIP.join_count, PIP.join_count_plain,
              jc_args, "point_in_polygon", "join_full_32",
              [first_polygons(a, SERVE_POLYGONS) for a in jc_args],
              SERVE_POLYGONS, first=3))

    # morton, at its own entry point (the index build's key step is
    # core/keys.morton_encode, as in the reference): the quantized
    # coordinates of the 2^23 build. Bytes: two int64 in, one out per
    # point; about 26 int32 operations per point.
    bx, bits = ex.spec.bounds, ex.spec.bits_per_dim
    mqx = K.quantize(torch.as_tensor(x, device=dev), bx[0], bx[2], bits)
    mqy = K.quantize(torch.as_tensor(y, device=dev), bx[1], bx[3], bits)
    n_m = mqx.shape[0]
    call = f"morton_{n_m}"
    torch.cuda.synchronize()
    KERN.reset_launch_counts()
    mkeys = MO.morton_encode(mqx, mqy)
    torch.cuda.synchronize()
    by_path["morton"] = KERN.launch_counts()
    path_launches[call] = {n: c for n, c in by_path["morton"].items() if c}
    require(path_launches[call] == {"morton": 1},
            f"morton path launched {path_launches[call]}")
    err = int((mkeys - MO.morton_encode_plain(mqx, mqy)).abs().max())
    require(torch.equal(mkeys, K.morton_encode(mqx, mqy)),
            "morton kernel vs core/keys.morton_encode")
    t = timed(lambda: MO.morton_encode(mqx, mqy), 50, "morton_kernel")
    # the arrays (201 MB) are four times the L2: the cold-cache time
    # beside the trace's back-to-back one
    t["cold_ms"] = stream_ms(lambda: MO.morton_encode(mqx, mqy), 20,
                             cold=True)
    pt = timed(lambda: MO.morton_encode_plain(mqx, mqy), 10)
    entry("morton", err, t, pt, 24 * n_m, 26 * n_m, None, call,
          peak_ops=PEAK_I32)
    log(f"[morton] {n_m} points bitwise against its plain version and "
        "core/keys.morton_encode")

    for row in rows:
        if row["name"] in upd_err:
            row["update_max_abs_err"] = upd_err[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     upd_err[row["name"]])

    phase("denormals")
    # 13. the flushed kernels on denormal inputs (comparison launches,
    # counted on no path)
    report["denormals"] = denormal_phase(dev)
    for row in rows:
        if row["name"] in report["denormals"]:
            err = report["denormals"][row["name"]]["max_abs_err"]
            row["denormal_max_abs_err"] = err
            row["max_abs_err"] = max(row["max_abs_err"], err)
    for row in rows:
        require(row["max_abs_err"] == 0, f"{row['name']} differs from plain")
    require(len(rows) == len(KERN.KERNELS), "a kernel row is missing")
    report["kernels"] = rows
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    phase("done")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restart"]:
        sys.exit(restart_main(sys.argv[2:]))
    sys.exit(main())
