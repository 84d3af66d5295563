"""Production-mesh dry run of the spatial engine on ``meta`` tensors.

The counterpart of the reference's ``src/repro/launch/dryrun_spatial.py``,
which lowers and compiles the distributed range, kNN and join programs
on 512 fake XLA devices over a ~1.07 B-point index that is never
allocated. Here rank 0 of a fake process group (world size 256 on the
single pod, 512 on the multi-pod mesh) runs its local programs on
``meta`` tensors at the true per-rank shapes: 4096 partitions of 262,144
padded slots, sharded over ("data",) or ("pod", "data") by
``core/local_ops.shard_partitions`` (256 or 128 rows a rank), the global
boxes and the query batch replicated. Nothing of the index is allocated.

The programs run on the ``torch`` backend: a CUDA kernel cannot run on
``meta`` tensors, so ``--backend cuda`` is refused. Per program the
report (``lilis-spatial__<shape>__<mesh>.json``) holds, under
``per_rank``, the shard's bytes per leaf, each output's shape, the
collectives issued (op, axis size, bytes; ``launch/mesh.recording``),
and the bytes the plain program reads and writes, op by op (a
``TorchDispatchMode`` over the meta ops). ``t_memory_s`` is those bytes
over the H100's HBM3 rate: the plain program's traffic, not a kernel's.

The kNN program is the serving form (``fixed_rounds=True``: all
``knn_max_rounds`` rounds, no host read), as the reference lowers its
``while_loop`` on the device; the strict form reads ``all(done)`` on the
host each round, which a meta tensor cannot answer.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_spatial --mesh both \\
      --out results/dryrun_spatial_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core.backends import TorchBackend
from repro_torch.core.build import LEAVES, LearnedSpatialIndex
from repro_torch.core.plan import EngineConfig
from repro_torch.launch import mesh as M

# ~1.07B points: 4096 partitions x 262144 padded slots
P_TOTAL = 4096
N_PAD = 262144
M_PAD = 512
RADIX_BITS = 10
Q = 1024
PG = 256
HBM_BYTES_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
META = torch.device("meta")


def fake_index() -> LearnedSpatialIndex:
    """The whole index as ``meta`` tensors, in the port's dtypes (keys
    int64): shapes only, no data."""
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    f32, i32 = torch.float32, torch.int32
    return LearnedSpatialIndex(
        key=t((P_TOTAL, N_PAD), torch.int64),
        x=t((P_TOTAL, N_PAD), f32), y=t((P_TOTAL, N_PAD), f32),
        vid=t((P_TOTAL, N_PAD), i32), count=t((P_TOTAL,), i32),
        knot_keys=t((P_TOTAL, M_PAD), f32),
        knot_pos=t((P_TOTAL, M_PAD), f32), n_knots=t((P_TOTAL,), i32),
        radix_table=t((P_TOTAL, (1 << RADIX_BITS) + 2), i32),
        radix_kmin=t((P_TOTAL,), f32), radix_scale=t((P_TOTAL,), f32),
        part_bounds=t((P_TOTAL, 4), f32),
        eps=32, radix_bits=RADIX_BITS, probe=128,
        key_spec=K.KeySpec(bounds=(0.0, 0.0, 1.0, 1.0)),
    )


def shard_threshold() -> tuple:
    """(query_shard_threshold, its source). The reference prefers the
    crossover its benchmark measured; the port reads no benchmark file
    yet, so this is the ``EngineConfig`` default."""
    return EngineConfig().query_shard_threshold, "default"


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteTally(TorchDispatchMode):
    """Bytes each aten op reads (its tensor arguments) and writes (its
    tensor results), summed: eager PyTorch's traffic, every intermediate
    through memory. Views move nothing and are skipped; collectives are
    logged by ``launch/mesh`` instead."""

    def __init__(self):
        super().__init__()
        self.read = 0
        self.written = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.namespace == "c10d":
            return out
        self.ops += 1
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        self.read += sum(_bytes(a) for a in ins
                         if isinstance(a, torch.Tensor))
        self.written += sum(_bytes(a) for a in outs
                            if isinstance(a, torch.Tensor))
        return out


def _q(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def programs(shard: LearnedSpatialIndex, cfg: EngineConfig, bk) -> list:
    """(name, local program, query args, queries) of the reference's
    four programs, on ``shard``."""
    rect_q = (_q((Q, 4)), _q((Q,)), _q((Q,)))
    return [
        ("range_mask", L._RangeCountLocal(shard, cfg, bk), rect_q, Q),
        ("range_window", L._RangeWindowLocal(
            shard, cfg, bk, cfg.range_cap, cfg.range_cand), rect_q, Q),
        ("knn10", L._KnnPrunedLocal(
            shard, cfg, bk, 10, cfg.knn_cand, cfg.knn_cap,
            fixed_rounds=True), (_q((Q,)), _q((Q,)), _q((Q,))), Q),
        ("join", L._JoinLocal(shard, cfg, bk, cfg.join_cap, cfg.join_cand),
         (_q((PG, 16, 2)), _q((PG,), torch.int32), _q((PG, 6))), PG),
    ]


def run(mesh_kind: str, out_dir: str) -> dict:
    """Rank 0's four programs on ``mesh_kind`` ("single" | "multi"), one
    JSON report each under ``out_dir``. Joins a fake process group of
    the mesh's world size and leaves it before returning."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    multi = mesh_kind == "multi"
    chips = 512 if multi else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        mesh = M.make_production_mesh(multi_pod=multi, device="cpu")
        part_axis = ("pod", "data") if multi else ("data",)
        axis = mesh.axis(part_axis)
        p_loc = P_TOTAL // axis.size
        index = fake_index()
        shard = L.shard_partitions(index, axis.offset(p_loc), p_loc)
        parts = L.part_arrays(shard)
        bounds = index.part_bounds
        threshold, src = shard_threshold()
        cfg = EngineConfig(part_chunk=8, range_cap=64, knn_cap=64,
                           range_cand=8, knn_cand=8, join_cap=128,
                           join_cand=8, backend="torch",
                           query_shard_threshold=threshold)
        print(f"# {mesh_kind}: {chips} ranks, part axis {part_axis} of "
              f"{axis.size}, rank 0 holds {p_loc} partition rows; "
              f"query_shard_threshold={threshold} ({src})", flush=True)
        leaf_bytes = {f: _bytes(getattr(shard, f)) for f in LEAVES
                      if getattr(shard, f) is not None}
        cells = {}
        for name, fn, qargs, nq in programs(shard, cfg, TorchBackend()):
            t0 = time.perf_counter()
            with M.recording() as coll, ByteTally() as tally:
                out = fn(parts, bounds, *qargs, axis=axis)
            outs = out if isinstance(out, tuple) else (out,)
            moved = tally.read + tally.written
            rep = {
                "arch": "lilis-spatial", "shape": name, "mesh": mesh_kind,
                "chips": chips, "points": P_TOTAL * N_PAD, "queries": nq,
                "query_shard_threshold": threshold,
                "query_shard_threshold_src": src,
                "run_s": time.perf_counter() - t0,
                "per_rank": {
                    "part_axis": list(part_axis),
                    "part_axis_size": axis.size,
                    "partition_rows": p_loc,
                    "shard_bytes": leaf_bytes,
                    "shard_bytes_total": sum(leaf_bytes.values()),
                    "outputs": [list(o.shape) for o in outs],
                    "collectives": coll,
                    "collective_bytes": sum(c["bytes"] for c in coll),
                    "plain_ops": tally.ops,
                    "plain_bytes_read": tally.read,
                    "plain_bytes_written": tally.written,
                    "t_memory_s": moved / HBM_BYTES_S,
                    "t_memory_of": "the plain torch program's op-by-op "
                                   "traffic on meta tensors over 3.35 "
                                   "TB/s (H100 HBM3), not a kernel's",
                },
            }
            path = os.path.join(out_dir,
                                f"lilis-spatial__{name}__{mesh_kind}.json")
            with open(path, "w") as f:
                json.dump(rep, f, indent=1)
            print(f"OK   spatial/{name}/{mesh_kind}: rows {p_loc}, plain "
                  f"read {tally.read} B written {tally.written} B "
                  f"({tally.ops} ops), t_memory_s {moved / HBM_BYTES_S:.6e}"
                  f", {len(coll)} collectives "
                  f"{rep['per_rank']['collective_bytes']} B, outputs "
                  f"{rep['per_rank']['outputs']}", flush=True)
            cells[name] = rep
        return cells
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--backend", default="torch", choices=["torch", "cuda"],
                    help="kernel backend of the local programs; only "
                         "torch runs on meta tensors")
    ap.add_argument("--out", default="results/dryrun_spatial_torch")
    args = ap.parse_args(argv)
    if args.backend != "torch":
        ap.error("--backend cuda: a CUDA kernel cannot run on meta "
                 "tensors; the dry run runs the torch backend only")
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mk in (["single", "multi"] if args.mesh == "both"
               else [args.mesh]):
        try:
            run(mk, args.out)
        except Exception:
            failures += 1
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
