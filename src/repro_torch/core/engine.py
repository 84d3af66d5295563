"""SpatialEngine: the method-per-query-type facade over the Executor.

    from repro_torch.core import SpatialEngine, build_index, fit
    eng = SpatialEngine(build_index(x, y, fit("kdtree", x, y, 64)))
    found = eng.point_query(qx, qy)
    counts = eng.range_count(rects)
    d2, vid = eng.knn(qx, qy, 10, mode="exact")

Both build_index and SpatialEngine run on the card by default; pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.executor import Executor
from repro_torch.core.plan import (PENDING, EngineConfig, Knn, PointQuery,
                                   RangeCount)


class SpatialEngine:
    """Batched spatial query engine over a LearnedSpatialIndex."""

    def __init__(self, index: LearnedSpatialIndex,
                 config: Optional[EngineConfig] = None, device="cuda"):
        self.executor = Executor(index, config=config, device=device)

    @property
    def index(self):
        return self.executor.index

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

    def point_query(self, qx, qy):
        """Exact membership (paper §4.1): found (Q,) bool."""
        return self.executor.run(PointQuery(), qx, qy)

    def range_count(self, rects):
        """Exact in-rect counts (paper §4.2): (Q,) int32."""
        return self.executor.run(RangeCount(), rects)

    def knn(self, qx, qy, k: int, mode: str = "pruned"):
        """k nearest neighbours: (dist2 (Q, k), vid (Q, k)). Only
        mode="exact" is ported; "pruned" raises NotImplementedError."""
        if mode != "exact":
            raise NotImplementedError(
                f"knn(mode={mode!r}) is not ported yet: it needs {PENDING}")
        return self.executor.run(Knn(k=k, mode=mode), qx, qy, strict=True)
