"""Core of the port: keys, partitioners, learned index build, plans,
backends, local programs, executor and engine facade."""
from repro_torch.core.build import (LearnedSpatialIndex, assign_partitions,
                                    build_index, fit_partitions, probe_for)
from repro_torch.core.engine import SpatialEngine
from repro_torch.core.executor import Executor
from repro_torch.core.keys import KeySpec
from repro_torch.core.partitioner import Partitioner, fit
from repro_torch.core.plan import (CircleQuery, EngineConfig, Knn,
                                   PointQuery, QuerySpec, RangeCount,
                                   RangeQuery, SpatialJoin)

__all__ = [
    "CircleQuery", "EngineConfig", "Executor", "KeySpec", "Knn",
    "LearnedSpatialIndex", "Partitioner", "PointQuery", "QuerySpec",
    "RangeCount", "RangeQuery", "SpatialEngine", "SpatialJoin",
    "assign_partitions", "build_index", "fit", "fit_partitions",
    "probe_for",
]
