#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and
check it. Run from the repository root, on a machine with a card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a
result line):

  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel of the main path from src/repro_torch/kernels/
              csrc, one nvcc per source, all at once;
  3. golden   tests/golden/spatial_golden.json's point, range_count and
              exact-kNN keys replayed bitwise with backend="cuda" on the
              golden inputs rebuilt by the port;
  4. build    the full-size index on the card: taxi, 2^23 points, seed 0,
              kdtree with 128 partitions;
  5. main     the main path once through SpatialEngine (1,024 point
              queries, 1,024 range counts at selectivity 1e-5, 256 exact
              10-NN queries) with every launch count set to 0 just before
              and read just after; results held bitwise against the
              plain-PyTorch backend on the card and against a numpy
              brute-force oracle on 64 queries; batch latencies, and
              the device's busy time and idle share from a profiler
              trace of each call;
  6. kernels  each kernel against its plain version at the shapes the
              main path gives it (bitwise), with its device time (a
              torch.profiler trace), the plain version's, one library
              call's where PyTorch has one, and the bound from this
              run's inputs (bytes over 3.35 TB/s or float32 operations
              over 67 TFLOP/s, whichever is larger).

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
N_POINTS = 1 << 23
N_PARTS = 128
DEVICE = "cuda"          # where the port runs, and the kernel backend
BACKEND = "cuda"
REPLACES = {
    "spline_search": "src/repro/kernels/spline_search.py:94",
    "range_count": "src/repro/kernels/range_filter.py:57",
    "point_probe": "src/repro/kernels/point_probe.py:47",
    "knn_topk": "src/repro/kernels/knn_topk.py:83",
}
SOURCES = {
    "spline_search": "src/repro_torch/kernels/csrc/spline_search.cu",
    "range_count": "src/repro_torch/kernels/csrc/range_filter.cu",
    "point_probe": "src/repro_torch/kernels/csrc/point_probe.cu",
    "knn_topk": "src/repro_torch/kernels/csrc/knn_topk.cu",
}


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


def device_profile(fn, reps: int) -> dict:
    """{device activity name: device ms per call} over ``reps`` calls
    (after one warm call), from a torch.profiler (CUPTI) trace; empty
    when the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = _short(e.name)
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / reps for k, v in out.items()}


def timed(fn, reps: int, match=None) -> dict:
    """Device time per call (the activities whose name contains
    ``match``, or all of them) from the profiler, and the CUDA-event
    stream time per call. Where the trace shows no device activity the
    event time stands in, and ``source`` says so."""
    prof = device_profile(fn, reps)
    wall = cuda_ms(fn, reps)
    dev = sum(v for k, v in prof.items() if match is None or match in k)
    if dev > 0:
        return {"ms": dev, "wall_ms": wall, "source": "profiler"}
    return {"ms": wall, "wall_ms": wall, "source": "cuda events"}


def host_ms(fn, reps: int) -> float:
    """Median wall time of one synchronised call (after a warm call)."""
    import torch
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
    return x, y, part, qx, qy, rects


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
    from repro_torch.core import queries as Q
    from repro_torch.core.backends import TorchBackend
    from repro_torch.data import spatial as ds
    from repro_torch.kernels import _build
    from repro_torch.kernels import knn_topk as KNN
    from repro_torch.kernels import point_probe as PP
    from repro_torch.kernels import range_filter as RF
    from repro_torch.kernels import spline_search as SS

    dev = torch.device(DEVICE)
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
                          "knn_topk"}, f"kernel sources: {sorted(libs)}")
    log(f"[build] {len(libs)} kernels in {report['build_s']:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. golden replay with the CUDA kernels
    with open(ROOT / "tests" / "golden" / "spatial_golden.json") as f:
        golden = json.load(f)
    gx, gy, gpart, gqx, gqy, grects = golden_inputs(ds, fit)
    geng = SpatialEngine(build_index(gx, gy, gpart, device=DEVICE),
                         EngineConfig(backend=BACKEND), device=DEVICE)
    require(geng.point_query(gqx, gqy).tolist() == golden["point"],
            "golden point")
    require(geng.range_count(grects).tolist() == golden["range_count"],
            "golden range_count")
    gd2, gvid = geng.knn(gqx[:8], gqy[:8], 3, mode="exact")
    require(gd2.tolist() == golden["knn_exact_d2"], "golden knn_exact_d2")
    require(gvid.tolist() == golden["knn_exact_vid"], "golden knn_exact_vid")
    log("[golden] point, range_count, knn_exact_d2, knn_exact_vid: bitwise")

    # 4. full-size build on the card
    t0 = time.perf_counter()
    x, y = ds.make("taxi", N_POINTS, seed=0)
    part = fit("kdtree", x, y, N_PARTS, seed=0)
    report["data_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = build_index(x, y, part, device=DEVICE)
    torch.cuda.synchronize()
    report["index_build_s"] = time.perf_counter() - t0
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

    # 5. the main path, once, with the launch counts around it
    rng = np.random.default_rng(1)
    ix = rng.integers(0, N_POINTS, 512)
    qx = np.concatenate([x[ix], rng.random(512).astype(np.float32)])
    qy = np.concatenate([y[ix], rng.random(512).astype(np.float32)])
    rects = ds.random_rects(1024, 1e-5, part.bounds, seed=2, centers=(x, y))
    kx, ky = qx[256:512], qy[256:512]
    k = 10

    KERN.reset_launch_counts()
    found = eng.point_query(qx, qy)
    counts = eng.range_count(rects)
    d2, vid = eng.knn(kx, ky, k, mode="exact")
    torch.cuda.synchronize()
    launches = KERN.launch_counts()
    log(f"[main] launches {launches}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    require(found.shape == (1024,) and found.dtype == torch.bool, "point")
    require(counts.shape == (1024,) and counts.dtype == torch.int32, "rc")
    require(d2.shape == (256, k) and bool(torch.isfinite(d2).all()), "knn")
    require(bool(found[:512].all()), "every data point is found")
    plain = SpatialEngine(index, EngineConfig(backend="torch"),
                          device=DEVICE)
    require(torch.equal(found, plain.point_query(qx, qy)), "point vs plain")
    require(torch.equal(counts, plain.range_count(rects)), "rc vs plain")
    pd2, pvid = plain.knn(kx, ky, k, mode="exact")
    require(torch.equal(d2, pd2) and torch.equal(vid, pvid), "knn vs plain")
    oracle_checks(x, y, qx, qy, rects, kx, ky, found.cpu().numpy(),
                  counts.cpu().numpy(), d2.cpu().numpy(), vid.cpu().numpy(),
                  k)
    log("[main] cuda == torch backend bitwise; numpy oracle agrees on 64 "
        f"queries each; mean range count {float(counts.float().mean()):.1f}")

    calls = {
        "point_1024": lambda: eng.point_query(qx, qy),
        "range_count_1024": lambda: eng.range_count(rects),
        "knn10_exact_256": lambda: eng.knn(kx, ky, k, "exact"),
    }
    plain_calls = {
        "point_1024": lambda: plain.point_query(qx, qy),
        "range_count_1024": lambda: plain.range_count(rects),
        "knn10_exact_256": lambda: plain.knn(kx, ky, k, "exact"),
    }
    lat = {n: host_ms(fn, 5) for n, fn in calls.items()}
    lat_plain = {n: host_ms(fn, 3) for n, fn in plain_calls.items()}
    report["batch_ms"] = lat
    report["batch_ms_torch_backend"] = lat_plain
    report["where"] = {}
    for name, fn in calls.items():
        prof = device_profile(fn, 3)
        busy = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
        report["where"][name] = {"device_busy_ms": busy,
                                 "idle_share": 1.0 - busy / lat[name],
                                 "top_device_ms": top}
        log(f"[latency] {name}: cuda {lat[name]:.3f} ms (device busy "
            f"{busy:.3f} ms, idle share {1.0 - busy / lat[name]:.3f}), "
            f"torch backend {lat_plain[name]:.3f} ms")
        log(f"[where] {name}: " + "; ".join(f"{n} {t:.4f}" for n, t in top))

    # 6. each kernel against its plain version on the inputs the main
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
    overlap = Q.rect_overlaps_box(rect_t, ex.bounds)
    chunks = list(L._chunks(parts, c))
    tb = TorchBackend()
    rows = []

    def sweep(fn, arglist, **kws):
        return lambda: [fn(*a, **kws) for a in arglist]

    def entry(name, err, t, pt, nbytes, nops, lt):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = nops / PEAK_F32 * 1e3
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": t["ms"], "plain_ms": pt["ms"],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None if lt is None else lt["ms"],
               "ms_per_launch": t["ms"] / launches[name],
               "ms_source": t["source"], "wall_ms": t["wall_ms"],
               "plain_wall_ms": pt["wall_ms"], "bytes": nbytes, "ops": nops}
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
    t = timed(sweep(SS.spline_search, ss_args, **kw), 50,
              "spline_search_kernel")
    pt = timed(sweep(SS.spline_search_plain, ss_args, **kw), 3)
    lt = timed(sweep(torch.searchsorted, [
        (ch["keys_f"], q2[None, :].expand(ch["keys_f"].shape[0], -1)
         .contiguous()) for _, ch in chunks]), 20)
    st = SS.window_start(q2, parts["knot_keys"], parts["knot_pos"],
                         parts["radix_table"], n_pad, parts["radix_kmin"],
                         parts["radix_scale"], parts["n_knots"], **kw)
    m, r = parts["knot_keys"].shape[1], parts["radix_table"].shape[1]
    nq2 = q2.shape[0]
    nbytes = 4 * (nq2 * len(chunks) + p_total * (2 * m + r + 4) +
                  covered(st, st + probe, n_pad) + p_total * nq2)
    entry("spline_search", err, t, pt, nbytes,
          p_total * nq2 * (probe + 16), lt)

    # range_count: every chunk. Bytes: the rects, bounds and flags, x and
    # y over the union of the active [s, min(e, count)) intervals, the
    # output.
    rc_args, hi_all, s_all = [], [], []
    for lo, ch in chunks:
        s, e = tb.bounds(ch, klo, khi, **kw)
        act = overlap[:, lo:lo + c].t().contiguous()
        rc_args.append((rect_t, s, e, act, ch["count"], ch["x"], ch["y"]))
        s_all.append(s)
        hi_all.append(torch.where(act, torch.minimum(e, ch["count"][:, None]),
                                  s))
    err = 0
    for a in rc_args:
        err = max(err, int((RF.range_count(*a) -
                            RF.range_count_plain(*a)).abs().max()))
    t = timed(sweep(RF.range_count, rc_args), 50, "range_count_kernel")
    pt = timed(sweep(RF.range_count_plain, rc_args), 2)
    s_all, hi_all = torch.cat(s_all), torch.cat(hi_all)
    pairs = int((hi_all - s_all).clamp(min=0).sum())
    nq = rect_t.shape[0]
    nbytes = (16 * nq * len(chunks) + 9 * p_total * nq + 4 * p_total +
              8 * covered(s_all, hi_all, n_pad) + 4 * p_total * nq)
    entry("range_count", err, t, pt, nbytes, 4 * pairs, None)

    # point_probe: the first-match and the overflow candidate sets. Bytes:
    # the queries, key/x/y over the union of the windows, the output.
    qxt = torch.as_tensor(qx, device=dev)
    qyt = torch.as_tensor(qy, device=dev)
    qk = K.keys_to_f32(K.make_keys(qxt, qyt, ex.spec))
    prog = L._PointLocal(ex.index, ex.cfg, tb)
    pp_args = []
    for pid in prog.candidates(ex.bounds, qxt, qyt):
        start = prog.window_starts(parts, pid, qk)
        pp_args.append((pid.to(torch.int32), start.to(torch.int32), qk, qxt,
                        qyt, parts["keys_f"], parts["x"], parts["y"]))
    err = 0
    for a in pp_args:
        err = max(err, int((PP.point_probe(*a, probe=probe) -
                            PP.point_probe_plain(*a, probe=probe)
                            ).abs().max()))
    t = timed(sweep(PP.point_probe, pp_args, probe=probe), 100,
              "point_probe_kernel")
    pt = timed(sweep(PP.point_probe_plain, pp_args, probe=probe), 10)
    nq = qk.shape[0]
    flat = torch.cat([a[0].to(torch.int64) * n_pad + a[1]
                      for a in pp_args])[None, :]
    win = covered(flat, flat + probe, p_total * n_pad)
    entry("point_probe", err, t, pt,
          len(pp_args) * nq * 24 + 12 * win + 4 * len(pp_args) * nq,
          3 * len(pp_args) * nq * probe, None)

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
    entry("knn_topk", err, t, pt,
          8 * npts + 8 * nq * len(chunks) + 8 * p_total * nq * k,
          5 * nq * npts, None)

    for row in rows:
        require(row["max_abs_err"] == 0, f"{row['name']} differs from plain")
    report["kernels"] = rows
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
