"""Spatial serving launcher (the paper's decision-analysis scenario): a
mixed QuerySpec workload through the adaptive executor.

``python -m repro_torch.launch.serve --spatial --n 200000 --rounds 8``
serves rounds of mixed batches (``--batch`` queries each) through a
``SpatialServeSession`` and prints each round's wall time and how many
host syncs it added (a steady round adds none).

Add ``--scheduler`` to serve single-query requests through the
streaming front door (serve/scheduler.py, DESIGN.md §12): 8 client
threads submitting round-robin point, range count, 10-NN and circle
requests plus an insert stream, a worker thread coalescing them into
micro-batches, maintenance at idle. It prints req/s, p50/p99 latency
per request, the mean and max batch, and the maintain runs.

Both run on the card unless given ``--device cpu``; ``--compile-cache
DIR`` keeps the CUDA kernel libraries on disk (DESIGN.md §14). The LM
serving mode of the reference's launcher is not ported (ROADMAP item
19).
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core import (CircleQuery, EngineConfig, InsertBatch, Knn,
                              PointQuery, RangeCount, RangeQuery,
                              SpatialJoin, build_index, fit)
from repro_torch.core.plan import BACKENDS
from repro_torch.data import spatial as ds
from repro_torch.launch.spatial import sync
from repro_torch.serve import SpatialServeSession


def build_session(args):
    """Taxi points (seed 0), kdtree 64 partitions, a serving session on
    ``args.device``. Returns (x, y, part, session)."""
    print(f"building index over {args.n} points ...")
    x, y = ds.make("taxi", args.n, seed=0)
    part = fit("kdtree", x, y, 64, seed=0)
    session = SpatialServeSession(
        build_index(x, y, part, device=args.device),
        config=EngineConfig(backend=args.backend,
                            compile_cache_dir=args.compile_cache),
        device=args.device)
    print(f"backend={session.stats()['backend']} "
          f"device={session.executor.device}")
    return x, y, part, session


def scheduler_requests(x, y, part, n_req: int):
    """``n_req`` single-query requests, round-robin point, range count
    (selectivity 1e-5), 10-NN and circle (r = 0.02), on data points."""
    rng = np.random.default_rng(1)
    rects = ds.random_rects(n_req, 1e-5, part.bounds, seed=2,
                            centers=(x, y))
    reqs = []
    for i in range(n_req):
        j = int(rng.integers(0, len(x)))
        kind = i % 4
        if kind == 0:
            reqs.append((PointQuery(), x[j:j + 1], y[j:j + 1]))
        elif kind == 1:
            reqs.append((RangeCount(), rects[i:i + 1]))
        elif kind == 2:
            reqs.append((Knn(k=10), x[j:j + 1], y[j:j + 1]))
        else:
            reqs.append((CircleQuery(), x[j:j + 1], y[j:j + 1],
                         np.full(1, 0.02, np.float32)))
    return reqs


def insert_stream(x, y, b: int):
    """The ingest batch: the first ``b`` points moved by 1e-4."""
    return ((x[:b] + 1e-4).astype(np.float32),
            (y[:b] + 1e-4).astype(np.float32))


def run_spatial_scheduler(args):
    """Concurrent traffic through the scheduler front door."""
    x, y, part, session = build_session(args)
    reqs = scheduler_requests(x, y, part, args.rounds * args.batch)
    print("warmup (sticky tiers settle off the hot path)")
    session.warmup(reqs[:4])

    lat_us = []
    lock = threading.Lock()
    with session.scheduler() as sched:
        bx, by = insert_stream(x, y, args.batch)
        sched.submit(InsertBatch(), bx, by).result(120.0)  # prewarm

        def client(k, nc=8):
            mine = []
            for i in range(k, len(reqs), nc):
                t0 = time.perf_counter()
                sched.submit(*reqs[i]).result(120.0)
                mine.append((time.perf_counter() - t0) * 1e6)
            with lock:
                lat_us.extend(mine)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        ing = threading.Thread(
            target=lambda: sched.submit(InsertBatch(), bx, by)
            .result(120.0))
        ing.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ing.join()
        wall = time.perf_counter() - t0
        sched.drain()
        st = sched.stats()
    lat = np.asarray(lat_us)
    print(f"{len(reqs)} requests from 8 clients in {wall:.2f}s "
          f"({len(reqs) / wall:.0f} req/s)")
    print(f"p50 {np.percentile(lat, 50):,.0f} us   "
          f"p99 {np.percentile(lat, 99):,.0f} us   "
          f"mean batch {st['mean_batch']}   max {st['max_batch']}   "
          f"maintain {st['maintain_runs']} runs "
          f"({st['maintain_busy']} busy)")


def run_spatial(args):
    """Rounds of mixed batches through the session; maintain() between
    rounds, off the hot path."""
    x, y, part, session = build_session(args)
    rng = np.random.default_rng(1)
    q = args.batch

    def make_round(seed):
        ix = rng.integers(0, args.n, q)
        rects = ds.random_rects(q, 1e-5, part.bounds, seed=seed,
                                centers=(x, y))
        polys, ne = ds.random_polygons(max(q // 8, 4), part.bounds,
                                       seed=seed)
        return [(PointQuery(), x[ix], y[ix]),
                (RangeCount(), rects),
                (RangeQuery(), rects),
                (CircleQuery(), x[ix], y[ix],
                 np.full(q, 0.02, np.float32)),
                (Knn(k=10), x[ix], y[ix]),
                (SpatialJoin(), polys, ne)]

    print("warmup (sticky tiers settle off the hot path)")
    session.warmup(make_round(0))
    syncs0 = session.stats()["host_syncs"]

    for rnd in range(args.rounds):
        reqs = make_round(rnd + 1)
        sync(args.device)
        t0 = time.perf_counter()
        session.submit_batch(reqs)
        sync(args.device)
        dt = time.perf_counter() - t0
        st = session.stats()
        print(f"round {rnd}: {len(reqs)} mixed specs in {dt*1e3:7.2f} ms "
              f"(host_syncs +{st['host_syncs'] - syncs0}, "
              f"cache {st['cache_size']} executables)")
        moved = session.maintain()       # re-tune OFF the hot path
        if moved:
            print(f"  maintain: escalated {moved}")
        syncs0 = session.stats()["host_syncs"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spatial", action="store_true",
                    help="serve mixed spatial QuerySpecs (required: the "
                         "LM mode is not ported)")
    ap.add_argument("--scheduler", action="store_true",
                    help="with --spatial: serve through the streaming "
                         "scheduler (concurrent clients, coalesced "
                         "micro-batches, idle maintenance)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="spatial kernel backend (auto: cuda on the "
                         "card, torch on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="on-disk store of the CUDA kernel libraries "
                         "(DESIGN.md §14)")
    args = ap.parse_args(argv)
    if not args.spatial:
        ap.error("only --spatial is ported: LM serving waits for "
                 "ROADMAP item 19")
    if args.scheduler:
        run_spatial_scheduler(args)
    else:
        run_spatial(args)


if __name__ == "__main__":
    main()
