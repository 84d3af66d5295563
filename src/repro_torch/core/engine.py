"""SpatialEngine: the method-per-query-type facade over the Executor.

    from repro_torch.core import SpatialEngine, build_index, fit
    eng = SpatialEngine(build_index(x, y, fit("kdtree", x, y, 64)))
    found = eng.point_query(qx, qy)
    counts = eng.range_count(rects)
    cnt, vids, ok = eng.range_query(rects)
    inside = eng.circle_count(cx, cy, r)
    d2, vid = eng.knn(qx, qy, 10)                 # pruned; or mode="exact"
    per_poly = eng.join_count(polys, n_edges)     # or mode="full"
    vids = eng.insert(xs, ys)                     # into the delta buffers
    removed = eng.delete(xs[:5], ys[:5])          # tombstones
    eng.refit()                                   # compact + re-fit

The adaptive methods run the strict escalation loop (``strict=True``),
as the reference's facade does; ``run`` and ``run_batch`` default to
serving mode (``strict=False``). Both build_index and SpatialEngine run
on the card by default; pass ``device="cpu"`` to run on the CPU.
``mesh`` (``launch/mesh.make_host_mesh``), ``part_axis`` and
``query_axis`` shard the engine over the ranks of a torch.distributed
world, one process per rank (core/executor.py).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.executor import Executor
from repro_torch.core.plan import (CircleQuery, DeleteBatch, EngineConfig,
                                   InsertBatch, Knn, PointQuery, RangeCount,
                                   RangeQuery, SpatialJoin)


class SpatialEngine:
    """Batched spatial query engine over a LearnedSpatialIndex.

    mesh=None: one device; otherwise partitions shard over ``part_axis``
    (and query batches optionally over ``query_axis``)."""

    def __init__(self, index: LearnedSpatialIndex,
                 config: Optional[EngineConfig] = None, device="cuda",
                 mesh=None, part_axis="data", query_axis=None):
        self.executor = Executor(index, config=config, device=device,
                                 mesh=mesh, part_axis=part_axis,
                                 query_axis=query_axis)

    @property
    def index(self):
        return self.executor.index

    @property
    def mesh(self):
        return self.executor.mesh

    @property
    def backend(self) -> str:
        """Resolved kernel backend name ("torch" | "cuda")."""
        return self.executor.backend.name

    @property
    def device(self):
        return self.executor.device

    def run(self, spec, *args, strict: bool = False):
        """Dispatch a QuerySpec (see core/plan.py) through the executor."""
        return self.executor.run(spec, *args, strict=strict)

    def run_batch(self, requests, strict: bool = False):
        """A mixed batch of (spec, *args) requests, in order (serving
        mode unless ``strict``)."""
        return self.executor.run_batch(requests, strict=strict)

    def point_query(self, qx, qy):
        """Exact membership (paper §4.1): found (Q,) bool."""
        return self.executor.run(PointQuery(), qx, qy)

    def range_count(self, rects):
        """Exact in-rect counts (paper §4.2): (Q,) int32."""
        return self.executor.run(RangeCount(), rects)

    def range_query(self, rects, cap: Optional[int] = None):
        """Windowed materializing range query: (counts, vids (Q, W)
        padded -1, ok). ``cap`` overrides the starting window once."""
        return self.executor.run(RangeQuery(cap=cap), rects, strict=True)

    def circle_count(self, cx, cy, r):
        """Circle range query via MBR + distance refine (paper Remark 2):
        counts (Q,) int32."""
        return self.executor.run(CircleQuery(), cx, cy, r, strict=True)

    def circle_query(self, cx, cy, r):
        """Materializing circle query: (counts, vids padded -1, ok)."""
        return self.executor.run(CircleQuery(materialize=True),
                                 cx, cy, r, strict=True)

    def knn(self, qx, qy, k: int, mode: str = "pruned"):
        """Exact k nearest neighbours: (dist2 (Q, k), vid (Q, k))."""
        return self.executor.run(Knn(k=k, mode=mode), qx, qy, strict=True)

    def join_count(self, polys, n_edges, mode: str = "windowed"):
        """Counts (PG,) of points inside each polygon. polys (PG, E, 2)
        padded vertex lists; n_edges (PG,) int32."""
        return self.executor.run(SpatialJoin(mode=mode), polys, n_edges,
                                 strict=True)

    # -- mutations (epoch-versioned mutable index, DESIGN.md §11) --------

    @property
    def epoch(self) -> int:
        """Mutation epoch of the resident index."""
        return self.executor.index.epoch

    def insert(self, xs, ys):
        """Batched insert into the per-partition delta buffers. Returns
        the assigned point ids (B,)."""
        return self.executor.run(InsertBatch(), xs, ys)

    def delete(self, xs, ys) -> int:
        """Batched delete by coordinate (tombstones every live copy).
        Returns the number of removed points."""
        return self.executor.run(DeleteBatch(), xs, ys)

    def refit(self, touched=None):
        """Compaction + spline re-fit of ``touched`` (default: every
        dirty) partitions. Returns the partition ids re-fit."""
        return self.executor.refit(touched)
