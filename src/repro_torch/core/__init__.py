"""Core of the port: keys, partitioners, learned index build, plans,
backends, local programs, executor and engine facade, and the mutable
index's updates (``mutate``)."""
from repro_torch.core.build import (LearnedSpatialIndex, assign_partitions,
                                    build_index, fit_partitions, probe_for)
from repro_torch.core.engine import SpatialEngine
from repro_torch.core.executor import Executor
from repro_torch.core.keys import KeySpec
from repro_torch.core.mutate import (delta_occupancy, refit_partitions,
                                     verify_eps, with_delta_capacity)
from repro_torch.core.partitioner import Partitioner, fit
from repro_torch.core.plan import (ALL_SPEC_TYPES, ALL_UPDATE_TYPES,
                                   CircleQuery, DeleteBatch, EngineConfig,
                                   InsertBatch, Knn, PointQuery, QuerySpec,
                                   RangeCount, RangeQuery, Refit,
                                   SpatialJoin, UpdateSpec)

__all__ = [
    "ALL_SPEC_TYPES", "ALL_UPDATE_TYPES", "CircleQuery", "DeleteBatch",
    "EngineConfig", "Executor", "InsertBatch", "KeySpec", "Knn",
    "LearnedSpatialIndex", "Partitioner", "PointQuery", "QuerySpec",
    "RangeCount", "RangeQuery", "Refit", "SpatialEngine", "SpatialJoin",
    "UpdateSpec", "assign_partitions", "build_index", "delta_occupancy",
    "fit", "fit_partitions", "probe_for", "refit_partitions", "verify_eps",
    "with_delta_capacity",
]
