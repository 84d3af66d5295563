"""End-to-end spatial decision analysis on the PyTorch/CUDA port (the
paper's use case): "which shops fall within each commercial zone?" — a
polygon x points broadcast join + density ranking, served from the
learned index, plus a distributed variant over a torch.distributed
world.

The twin of ``examples/spatial_analytics.py`` (the JAX package's).
``--dist`` shards the partitions over the ranks of the world, one
process per rank (NCCL on the card, one card per rank; gloo with
``--device cpu``); every rank runs the whole analysis and only rank 0
prints.

    PYTHONPATH=src python examples/spatial_analytics_torch.py
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 examples/spatial_analytics_torch.py --dist \\
        --device cpu --n 20000
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import Executor, Knn, SpatialJoin, build_index, fit
from repro_torch.data import spatial as ds
from repro_torch.launch import mesh as M


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--zones", type=int, default=32)
    ap.add_argument("--dist", action="store_true",
                    help="shard partitions over the ranks of the world "
                         "(run under torch.distributed.run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    mesh = None
    if args.dist:
        dev = M.init_process(dev)
    rank0 = not args.dist or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *_a, **_k: None)

    say(f"{args.n} shops, {args.zones} commercial zones")
    x, y = ds.make("taxi", args.n, seed=7)          # shop locations
    part = fit("kdtree", x, y, 64, seed=0)
    index = build_index(x, y, part, device=dev)

    if args.dist:
        n_dev = M.world_size()
        mesh = M.make_host_mesh((n_dev,), ("data",), device=dev)
        say(f"distributed over {n_dev} devices")
    executor = Executor(index, device=dev, mesh=mesh, part_axis="data")

    zones, n_edges = ds.random_polygons(args.zones, part.bounds, seed=3,
                                        radius=0.05)
    t0 = time.perf_counter()
    counts = executor.run(SpatialJoin(), zones, n_edges).cpu().numpy()
    dt = time.perf_counter() - t0
    order = np.argsort(-counts)
    say(f"join of {args.zones} zones x {args.n} shops: {dt*1e3:.0f} ms")
    say("densest zones (zone id, shop count):")
    for i in order[:5]:
        say(f"  zone {i:3d}: {counts[i]:6d} shops")

    # follow-up: 10 nearest shops to each of the top zone centroids
    cent = np.stack([zones[order[:5], :, 0].mean(axis=1),
                     zones[order[:5], :, 1].mean(axis=1)], axis=1)
    d2, ids = executor.run(Knn(k=10), cent[:, 0].astype(np.float32),
                           cent[:, 1].astype(np.float32))
    say("nearest shops to densest zone:", ids.cpu().numpy()[0][:5])
    if mesh is not None:
        torch.distributed.barrier()     # every rank done before teardown
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
