"""Spatial analytics launcher: the paper's end-to-end scenario on one
device, or on a mesh of ranks.

Builds the learned index over a synthetic city-scale dataset and runs
batched spatial queries (point / range count / range / circle / kNN /
join) through the adaptive executor, printing build time and each
QuerySpec's batch latency (the third call: the first settles the sticky
tier, the second runs the steady program once).

``python -m repro_torch.launch.spatial --n 1000000 --partitions 64
--queries 256`` runs on the card; ``--device cpu`` on the CPU.
``--compile-cache DIR`` keeps the CUDA kernel libraries on disk, so a
restart loads them instead of running nvcc (DESIGN.md §14).

``--mesh host`` shards the partitions over the ranks of the world, one
process per rank: ``python -m torch.distributed.run --nproc_per_node N
-m repro_torch.launch.spatial --mesh host ...`` (NCCL on the card, one
card per rank; gloo with ``--device cpu``). ``--query-shard`` splits an
even world into a (data, query) mesh, the reference's shapes, and shards
batches of at least ``--query-shard-threshold`` queries over the query
axis. Every rank runs the whole scenario; only rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (CircleQuery, EngineConfig, Executor, Knn,
                              PointQuery, RangeCount, RangeQuery,
                              SpatialJoin, build_index, fit)
from repro_torch.core.plan import BACKENDS
from repro_torch.data import spatial as ds
from repro_torch.launch import mesh as MESH


def sync(device) -> None:
    """Wait until the work queued on ``device``'s current stream is done
    (nothing to wait for on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="taxi",
                    choices=list(ds.GENERATORS))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--partitions", type=int, default=64)
    ap.add_argument("--partitioner", default="kdtree",
                    choices=["fixed", "adaptive", "quadtree", "kdtree",
                             "rtree"])
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--selectivity", type=float, default=1e-5)
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="host: shard the partitions over the ranks of "
                         "a torch.distributed world (run under "
                         "torch.distributed.run)")
    ap.add_argument("--query-shard", action="store_true",
                    help="with --mesh host: split the ranks into a "
                         "(part, query) mesh and shard large query "
                         "batches over the query axis")
    ap.add_argument("--query-shard-threshold", type=int, default=None,
                    help="min batch size to query-shard (default: "
                         "EngineConfig default)")
    ap.add_argument("--backend", choices=list(BACKENDS), default="auto",
                    help="kernel backend for the lookup and scan stages "
                         "(auto: cuda on the card, torch on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="on-disk store of the CUDA kernel libraries "
                         "(DESIGN.md §14): a restart loads them instead "
                         "of running nvcc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = args.device
    if args.mesh == "host":
        device = MESH.init_process(device)
    rank0 = MESH.world_size() == 1 or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *_a, **_k: None)   # rank 0 prints

    say(f"generating {args.n} {args.dataset} points ...")
    x, y = ds.make(args.dataset, args.n, seed=args.seed)

    t0 = time.perf_counter()
    part = fit(args.partitioner, x, y, args.partitions, seed=args.seed)
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(x, y, part, device=device)
    sync(device)
    t_build = time.perf_counter() - t0
    sizes = index.size_bytes()
    say(f"partitioner fit {t_part*1e3:.0f} ms; index build "
          f"{t_build*1e3:.0f} ms; model {sizes['local_model']/1e3:.1f} KB"
          f" + global {sizes['global_index']/1e3:.1f} KB")

    cfg_kw = {"backend": args.backend}
    if args.query_shard_threshold is not None:
        cfg_kw["query_shard_threshold"] = args.query_shard_threshold
    if args.compile_cache:
        cfg_kw["compile_cache_dir"] = args.compile_cache
    mesh = query_axis = None
    if args.mesh == "host":
        n_dev = MESH.world_size()
        if args.query_shard and n_dev >= 2 and n_dev % 2 == 0:
            q_sz = 2
            # the largest power-of-two query axis that still leaves at
            # least half the ranks to the partition axis
            while n_dev % (q_sz * 2) == 0 and q_sz * 2 <= n_dev // 2:
                q_sz *= 2
            mesh = MESH.make_host_mesh((n_dev // q_sz, q_sz),
                                       ("data", "query"), device=device)
            query_axis = "query"
        else:
            if args.query_shard:
                say(f"--query-shard needs an even rank count >= 2 "
                      f"(have {n_dev}); using a partition-only mesh")
            mesh = MESH.make_host_mesh(device=device)
    ex = Executor(index, config=EngineConfig(**cfg_kw), device=device,
                  mesh=mesh, query_axis=query_axis)
    say(f"backend={ex.backend.name} device={ex.device} mesh="
          f"{mesh.shape if mesh else None} query_axis={query_axis}")
    rng = np.random.default_rng(args.seed)
    q = args.queries

    ix = rng.integers(0, args.n, q)
    qx, qy = x[ix], y[ix]
    rects = ds.random_rects(q, args.selectivity, part.bounds,
                            seed=args.seed, centers=(x, y))
    polys, n_edges = ds.random_polygons(max(q // 8, 8), part.bounds,
                                        seed=args.seed)

    workload = [
        ("point", PointQuery(), (qx, qy), q),
        ("range_count", RangeCount(), (rects,), q),
        ("range", RangeQuery(), (rects,), q),
        ("circle", CircleQuery(), (qx, qy,
                                   np.full(q, 0.01, np.float32)), q),
        ("knn", Knn(k=args.k), (qx[:64], qy[:64]), min(q, 64)),
        ("join", SpatialJoin(), (polys, n_edges), len(n_edges)),
    ]

    for name, spec, sargs, denom in workload:
        ex.run(spec, *sargs)      # settles the sticky tier
        ex.run(spec, *sargs)      # the steady program, once
        sync(device)
        t0 = time.perf_counter()
        ex.run(spec, *sargs)
        sync(device)
        dt = time.perf_counter() - t0
        say(f"{name:12s} {dt*1e3:9.2f} ms for batch "
              f"({dt/denom*1e6:8.1f} us/query)")
    st = ex.stats()
    say(f"executor: {st['cache_size']} cached executables, "
          f"{st['host_syncs']} host syncs total, sticky={st['sticky']}, "
          f"qshard_executables={st['qshard_executables']}")
    if mesh is not None:
        torch.distributed.barrier()     # every rank done before teardown
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
