"""Declarative query plans: frozen QuerySpec dataclasses.

A QuerySpec describes WHAT to compute (query type plus the static
parameters of its program); query arrays are passed to
``Executor.run(spec, *args)``.

This slice runs the exact specs (PointQuery, RangeCount, exact Knn).
The adaptive specs exist so callers can name them, but the executor
raises NotImplementedError for them until their windowed programs and
escalation policy are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BACKENDS = ("auto", "torch", "cuda")

# what the adaptive specs wait for (ROADMAP.md, "Modules to port")
PENDING = ("the windowed programs and the strict adaptive loop "
           "(ROADMAP.md module items 10-11)")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Executor knobs: how many partitions one backend call spans, and
    the kernel backend (auto | torch | cuda)."""
    part_chunk: int = 8          # partitions per backend call
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}: expected "
                             f"one of {BACKENDS}")
        if self.part_chunk <= 0:
            raise ValueError("part_chunk must be positive")


class QuerySpec:
    """Base class for declarative query descriptions."""

    kind: str = "?"
    n_args: int = 0              # number of positional data arguments


def _as_int(v, name: str, *, optional: bool = False) -> Optional[int]:
    if v is None:
        if optional:
            return None
        raise TypeError(f"{name} is required")
    v = int(v)
    if v <= 0:
        raise ValueError(f"{name} must be positive, got {v}")
    return v


def _as_choice(v, name: str, choices: Tuple[str, ...]) -> str:
    v = str(v)
    if v not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {v!r}")
    return v


@dataclasses.dataclass(frozen=True)
class PointQuery(QuerySpec):
    """Exact membership test. args: (qx (Q,), qy (Q,)) -> found (Q,) bool."""
    kind = "point"
    n_args = 2


@dataclasses.dataclass(frozen=True)
class RangeCount(QuerySpec):
    """Exact in-rect counts. args: (rects (Q, 4)) -> counts (Q,) int32."""
    kind = "range_count"
    n_args = 1


@dataclasses.dataclass(frozen=True)
class Knn(QuerySpec):
    """k nearest neighbours. args: (qx (Q,), qy (Q,)) ->
    (d2 (Q, k), vid (Q, k)). Only mode="exact" runs in this slice."""
    kind = "knn"
    n_args = 2
    k: int = 10
    mode: str = "pruned"

    def __post_init__(self):
        object.__setattr__(self, "k", _as_int(self.k, "k"))
        object.__setattr__(self, "mode",
                           _as_choice(self.mode, "mode",
                                      ("pruned", "exact")))


@dataclasses.dataclass(frozen=True)
class RangeQuery(QuerySpec):
    """Materializing windowed range query (not yet ported)."""
    kind = "range"
    n_args = 1
    cap: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "cap",
                           _as_int(self.cap, "cap", optional=True))


@dataclasses.dataclass(frozen=True)
class CircleQuery(QuerySpec):
    """Circle query via MBR window + distance refine (not yet ported)."""
    kind = "circle"
    n_args = 3
    materialize: bool = False


@dataclasses.dataclass(frozen=True)
class SpatialJoin(QuerySpec):
    """Polygon-contains-points join counts (not yet ported)."""
    kind = "join"
    n_args = 2
    mode: str = "windowed"
