"""Quickstart on the PyTorch/CUDA port: build a LiLIS learned spatial
index and query it through the declarative plan/executor API.

The twin of ``examples/quickstart.py`` (the JAX package's), making the
same calls through ``repro_torch.core`` and printing the same lines. A
query is described by a frozen QuerySpec (WHAT to compute) and executed
by the Executor (HOW: programs, candidate-window tuning, distribution).

    PYTHONPATH=src python examples/quickstart_torch.py            # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --n 20000
"""
import argparse

import numpy as np

from repro_torch.core import (CircleQuery, Executor, Knn, PointQuery,
                              RangeCount, RangeQuery, SpatialJoin,
                              build_index, fit)
from repro_torch.data import spatial as ds


def host(t) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    dev = args.device

    # 1. a synthetic "city" of 200k points
    x, y = ds.make("taxi", args.n, seed=0)

    # 2. spatial-aware partitioning (paper §3.1; KD-tree is the default)
    part = fit("kdtree", x, y, num_partitions=64)

    # 3. one-pass learned index build (paper §3.2)
    index = build_index(x, y, part, device=dev)
    sizes = index.size_bytes()
    print(f"index: {index.num_partitions} partitions, "
          f"model {sizes['local_model']/1e3:.0f} KB for "
          f"{len(x)*12/1e6:.0f} MB of points")

    # 4. one executor serves every query type (pass mesh=... to shard)
    ex = Executor(index, device=dev)

    # point query (paper §4.1)
    found = ex.run(PointQuery(), x[:4], y[:4])
    print("point query (known points):", host(found))

    # range count + materializing range query (paper §4.2)
    rects = ds.random_rects(8, 1e-4, part.bounds, seed=1, centers=(x, y))
    print("range counts:", host(ex.run(RangeCount(), rects)))
    cnt, vids, ok = ex.run(RangeQuery(), rects)
    print("range ids[0][:5]:", host(vids)[0][:5])

    # circle query with distance refine (paper Remark 2)
    r = np.full(4, 0.02, np.float32)
    print("circle counts:", host(ex.run(CircleQuery(), x[:4], y[:4], r)))

    # kNN (paper §4.3)
    d2, ids = ex.run(Knn(k=5), x[:4], y[:4])
    print("knn ids[0]:", host(ids)[0])

    # spatial join (paper §4.4)
    polys, n_edges = ds.random_polygons(4, part.bounds, seed=2)
    print("join counts:", host(ex.run(SpatialJoin(), polys, n_edges)))

    # mixed workloads dispatch through one entry point; once the
    # adaptive window tiers are sticky, re-runs make no host sync
    batch = ex.run_batch([(RangeCount(), rects), (Knn(k=5), x[:4], y[:4])])
    print("batched:", host(batch[0])[:4], "...,", host(batch[1][1])[0][:3])
    print("executor stats:", ex.stats())


if __name__ == "__main__":
    main()
