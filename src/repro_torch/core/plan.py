"""Declarative query plans: frozen QuerySpec dataclasses.

A QuerySpec describes WHAT to compute (query type plus the static
parameters of its program); query arrays are passed to
``Executor.run(spec, *args)``.

Exact specs (PointQuery, RangeCount, exact Knn) run one program. The
adaptive specs (RangeQuery, CircleQuery, pruned Knn, windowed
SpatialJoin) run the strict escalation loop over a (cap, cand) window
tier, or, once a tier is sticky and ``strict=False``, the fused serving
program; ``sticky_key()`` names the tier state an executor keeps per
spec family. A wide non-strict batch on a sticky tier takes the
tier-bucketed dispatch (``tier_buckets``, ``tier_bucket_min``,
``row_chunk_elems``; DESIGN.md §13).

UpdateSpecs (InsertBatch, DeleteBatch, Refit) mutate the executor's
index through the same ``Executor.run`` (DESIGN.md §11).

``exec_key`` names one entry of the executor's program cache, and
``cache_fingerprint`` the content address of one entry of the on-disk
store (core/compile_cache.py, DESIGN.md §14).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Executor knobs: how many partitions one backend call spans, the
    kernel backend (auto | torch | cuda), the initial window tiers of
    the adaptive specs, the serving knobs and the serve scheduler's
    (the reference's defaults)."""
    part_chunk: int = 8          # partitions per backend call
    backend: str = "auto"
    range_cap: int = 64          # windowed-range candidate cap/partition
    knn_cap: int = 64            # windowed kNN gather cap per partition
    knn_max_rounds: int = 24     # radius doublings (covers any dataset)
    join_cap: int = 128          # windowed join candidate cap/partition
    range_cand: int = 8          # candidate partitions per range query
    knn_cand: int = 8            # candidate partitions per kNN query
    join_cand: int = 8           # candidate partitions per polygon
    circle_cap: int = 64         # windowed circle candidate cap/partition
    circle_cand: int = 8         # candidate partitions per circle query
    query_shard_threshold: int = 1024   # min batch a meshed executor with
                                 # a query axis shards over it (§10)
    scan_chunk_elems: int = 1 << 26  # candidate-plane elements before the
                                     # chunked kNN top-k and circle
                                     # compaction merges engage
    tier_buckets: bool = True    # a wide non-strict batch on a sticky
                                 # tier: one need probe, then each row
                                 # at the lowest tier it is feasible at
    tier_bucket_min: int = 32    # min batch width before bucketing
    row_chunk_elems: int = 1 << 19  # bucketed dispatch: rows x (cap *
                                    # cand) per fused call
    demote_after: int = 3        # consecutive clean maintain() checks
                                 # before a sticky tier steps back down
    delta_cap: int = 128         # delta-buffer capacity floor on first
                                 # insert (grows by doubling; DESIGN §11)
    delta_occupancy: float = 0.5  # (buffered + tombstoned) / live
                                  # fraction above which the executor
                                  # schedules a deferred re-fit
    # -- streaming serve scheduler knobs (serve/scheduler.py, §12) ------
    serve_max_batch: int = 256   # micro-batch coalescing cap (per-spec
                                 # caps clamp below this)
    serve_coalesce_us: int = 200  # straggler wait once a partial batch
                                  # exists (worker mode only; drain()
                                  # never waits)
    serve_queue_depth: int = 4096  # backpressure bound: submit() blocks
                                   # while the queue is this deep
    serve_idle_maintain: bool = True  # run maintain() when the queue
                                      # drains (never between requests)
    # -- warm start (core/compile_cache.py, DESIGN.md §14) --------------
    compile_cache_dir: Optional[str] = None  # on-disk store root (None =
                                 # off): the CUDA kernel libraries, so a
                                 # second process loads them instead of
                                 # running nvcc
    compile_cache_bytes: int = 1 << 30  # size cap of the store's
                                 # entries; LRU-by-mtime eviction runs
                                 # after each store
    serve_async_precompile: bool = True  # the scheduler's worker mode
                                 # starts the executor's precompile
                                 # worker, which captures the predicted
                                 # next CUDA graphs off the serving
                                 # thread; a batch pads to the nearest
                                 # larger warm width until its own is
                                 # captured. Not part of any program
                                 # (the kernel store's fingerprint never
                                 # reads the config)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}: expected "
                             f"one of {BACKENDS}")
        if self.part_chunk <= 0:
            raise ValueError("part_chunk must be positive")


def exec_key(backend: str, base: Tuple, tag: str = "x",
             variant: Optional[Tuple] = None,
             qshard: bool = False, epoch: int = 0) -> Tuple:
    """Canonical program-cache key (DESIGN.md §10/§11 layout).

    ``(backend, qshard, base, tag, variant, epoch)``:

      backend   Backend.name: programs are never shared across kernel
                backends;
      qshard    True for the query-axis-sharded wrapping of the same
                program (a meshed executor with a query axis, for a
                batch of at least ``query_shard_threshold`` rows);
      base      the spec's sticky/cache base tuple (``sticky_key()`` for
                adaptive ops, a literal kind tuple otherwise);
      tag       program flavor within the base: "x" exact/simple,
                "w" strict windowed tier, "fused" zero-sync steady tier,
                "p" wide-batch feasibility probe (tier bucketing),
                "u" update (insert/delete) program;
      variant   the (cap, cand) tier for "w"/"fused" programs (the slot
                the executor's eviction policy sweeps), ``(cand,)`` for
                "p", or the data shapes (batch size, delta capacity) for
                "u" programs, so update programs cache like queries;
      epoch     the index's SHAPE epoch (not the mutation epoch): bumps
                only when a shape a program bakes changes (delta
                capacity, n_pad, knot width, probe). Programs stay
                cached across ordinary updates; ``_evict_stale`` sweeps
                superseded shape epochs.
    """
    return (str(backend), bool(qshard), tuple(base), str(tag), variant,
            int(epoch))


class QuerySpec:
    """Base class for declarative query descriptions."""

    kind: str = "?"
    n_args: int = 0              # number of positional data arguments

    def sticky_key(self) -> Tuple:
        """Identity of the shared adaptive (cap, cand) state."""
        return (self.kind,)


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
    """Exact k nearest neighbours. args: (qx (Q,), qy (Q,)) ->
    (d2 (Q, k), vid (Q, k))."""
    kind = "knn"
    n_args = 2
    k: int = 10
    mode: str = "pruned"

    def __post_init__(self):
        object.__setattr__(self, "k", _as_int(self.k, "k"))
        object.__setattr__(self, "mode",
                           _as_choice(self.mode, "mode",
                                      ("pruned", "exact")))

    def sticky_key(self):
        return (self.kind, self.k)


@dataclasses.dataclass(frozen=True)
class RangeQuery(QuerySpec):
    """Materializing windowed range query.

    args: (rects (Q, 4)) -> (counts (Q,), vids (Q, W) padded -1, ok (Q,)).
    ``cap`` overrides the initial per-partition window; the adaptive
    state stays shared by every RangeQuery (sticky_key "range")."""
    kind = "range"
    n_args = 1
    cap: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "cap",
                           _as_int(self.cap, "cap", optional=True))


@dataclasses.dataclass(frozen=True)
class CircleQuery(QuerySpec):
    """Circle query via MBR window + distance refine (paper Remark 2).

    args: (cx (Q,), cy (Q,), r (Q,)).
    materialize=False -> counts (Q,) int32
    materialize=True  -> (counts (Q,), vids (Q, W) padded -1, ok (Q,))
    """
    kind = "circle"
    n_args = 3
    materialize: bool = False

    def __post_init__(self):
        object.__setattr__(self, "materialize", bool(self.materialize))

    def sticky_key(self):
        # the counting and materializing variants gather different
        # window widths: separate adaptive state
        return (self.kind, self.materialize)


@dataclasses.dataclass(frozen=True)
class SpatialJoin(QuerySpec):
    """Polygon-contains-points broadcast join counts.

    args: (polys (PG, E, 2), n_edges (PG,)) -> counts (PG,) int32.
    """
    kind = "join"
    n_args = 2
    mode: str = "windowed"

    def __post_init__(self):
        object.__setattr__(self, "mode",
                           _as_choice(self.mode, "mode",
                                      ("windowed", "full")))


# ---------------------------------------------------------------------------
# update specs: mutations through the same executor (DESIGN.md §11)
# ---------------------------------------------------------------------------

class UpdateSpec(QuerySpec):
    """Base class for declarative index mutations. Like a query, an
    UpdateSpec carries no data: batches are passed to
    ``Executor.run(spec, *args)``."""


@dataclasses.dataclass(frozen=True)
class InsertBatch(UpdateSpec):
    """Batched insert. args: (xs (B,), ys (B,)) -> assigned vids (B,).

    Points are appended to their partition's delta buffer; the spline is
    not re-fit (that waits for ``Refit`` or the executor's
    occupancy-triggered ``maintain()`` compaction)."""
    kind = "insert"
    n_args = 2


@dataclasses.dataclass(frozen=True)
class DeleteBatch(UpdateSpec):
    """Batched delete by coordinate. args: (xs (B,), ys (B,)) ->
    removed count (int). Removes EVERY live copy of each (x, y)."""
    kind = "delete"
    n_args = 2


@dataclasses.dataclass(frozen=True)
class Refit(UpdateSpec):
    """Compaction + per-partition spline re-fit of every dirty partition
    (buffered inserts or tombstones). args: () -> the list of partition
    ids re-fit. Targeted re-fit: ``Executor.refit(touched)``."""
    kind = "refit"
    n_args = 0


ALL_SPEC_TYPES = (PointQuery, RangeCount, RangeQuery, CircleQuery, Knn,
                  SpatialJoin)
ALL_UPDATE_TYPES = (InsertBatch, DeleteBatch, Refit)


# ---------------------------------------------------------------------------
# on-disk store fingerprinting (DESIGN.md §14)
# ---------------------------------------------------------------------------

# bump when the stored layout or the fingerprint recipe changes: old
# entries become unreachable (and are LRU-evicted), never misread
CACHE_SCHEMA = 1


def _canon(v) -> str:
    """Deterministic, recursion-stable rendering of a key component.

    repr() is already stable for the ints, strs, bools and tuples of
    exec_key and EngineConfig; floats and numpy scalars are rendered
    explicitly so the same logical entry always maps to one address.
    """
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_canon(u) for u in v) + ")"
    if isinstance(v, dict):
        return "{" + ",".join(f"{_canon(k)}:{_canon(v[k])}"
                              for k in sorted(v, key=str)) + "}"
    if isinstance(v, float):
        return float(v).hex()
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return repr(v)
    if dataclasses.is_dataclass(v):
        return _canon(dataclasses.asdict(v))
    # numpy scalars and anything else with a stable item()/repr
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _canon(item())
        except Exception:
            pass
    return repr(v)


def cache_fingerprint(context: dict, key: Tuple, args_sig: Tuple) -> str:
    """Content address of one stored entry.

    ``context`` is the process-level invariants (compile_cache.
    process_context: schema, torch and CUDA versions, nvcc, the card);
    ``key`` names the entry (``("kernel", name)`` for a kernel library);
    ``args_sig`` is what specializes it (for a library, the hash that
    kernels/_build.lib_path takes of its source, headers and flags).
    """
    text = f"v{CACHE_SCHEMA}|{_canon(context)}|{_canon(key)}|" \
           f"{_canon(args_sig)}"
    return hashlib.sha256(text.encode()).hexdigest()
