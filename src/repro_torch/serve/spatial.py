"""Spatial query serving: mixed QuerySpec batches over one Executor.

A long-lived process answering heterogeneous spatial queries (point
lookups, range analytics, kNN, zone joins) against one resident learned
index, the paper's decision-analysis scenario. Everything dispatches
through ``Executor.run``, so:

  - a steady request on a sticky tier runs one fused program with zero
    host syncs (no retry chain, no host read of the ok flags);
  - ``warmup`` settles the sticky tiers before traffic arrives;
  - ``maintain`` re-tunes the tiers between batches, off the hot path,
    and runs the compaction that updates scheduled;
  - ``insert``, ``delete`` and ``refit`` mutate the resident index
    (DESIGN.md §11); queries stay exact at once;
  - ``scheduler`` opens the streaming front door over the same executor
    (serve/scheduler.py), and in worker mode its precompile worker;
  - ``manifest`` and ``prewarm`` carry the realized programs (on the
    card, CUDA graphs) and sticky tiers over to another session or
    process (DESIGN.md §14).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.executor import Executor
from repro_torch.core.plan import (DeleteBatch, EngineConfig, InsertBatch,
                                   QuerySpec)
from repro_torch.serve.scheduler import SpatialScheduler


class SpatialServeSession:
    """Serve mixed spatial query batches from a resident learned index,
    on ``device`` (default: the card; "cpu" to run on the CPU); with
    ``mesh``, as one rank of a mesh (``part_axis``, ``query_axis``: see
    core/executor.py)."""

    def __init__(self, index: LearnedSpatialIndex,
                 config: Optional[EngineConfig] = None, device="cuda",
                 mesh=None, part_axis="data", query_axis=None):
        self.executor = Executor(index, config=config, device=device,
                                 mesh=mesh, part_axis=part_axis,
                                 query_axis=query_axis)

    @property
    def mesh(self):
        return self.executor.mesh

    def scheduler(self, bench=None, start: bool = True):
        """The streaming front door (serve/scheduler.py, DESIGN.md §12):
        a request queue and a background worker coalescing concurrent
        submissions into micro-batches over THIS session's executor, with
        write barriers and idle-time maintain(). ``bench`` is a benchmark
        record (dict or JSON path) for the per-spec batch caps (default:
        none, every spec coalesces to ``serve_max_batch``);
        ``start=False`` skips the worker thread: callers pump
        ``drain()``. In worker mode, with
        ``EngineConfig.serve_async_precompile`` (the default), the
        scheduler starts this session's executor's precompile worker,
        which captures the CUDA graphs of new batch widths and tiers off
        the serving thread, and its ``close()`` stops it; pass a config
        with ``serve_async_precompile=False`` to keep every capture on
        the serving thread. Refused (ValueError) on a mesh of more than
        one rank."""
        return SpatialScheduler(self.executor, bench=bench, start=start)

    def warmup(self, requests: Sequence[Tuple]) -> None:
        """Run representative requests before traffic arrives: the
        strict pass settles the sticky (cap, cand) tiers, the second,
        non-strict pass runs the steady serving programs once."""
        self.executor.run_batch(requests, strict=True)
        self.executor.run_batch(requests)

    # -- warm start (manifest + prewarm, DESIGN.md §14) ------------------

    def manifest(self) -> dict:
        """Snapshot of every realized program family (exec keys, argument
        signatures, sticky tiers): feed it to a later process's
        ``prewarm`` to realize them before traffic."""
        return self.executor.manifest()

    def prewarm(self, manifest: dict, exercise: bool = False) -> dict:
        """Replay a recorded ``manifest()``: install the delta capacity
        and sticky tiers, then realize every recorded (program,
        signature), on the card capturing its CUDA graph. With
        ``EngineConfig.compile_cache_dir`` warm, the kernel libraries
        come from the disk store. ``exercise=True`` also runs one
        discarded zero-query batch per read family to absorb the host
        side's first-use cost (the restart path)."""
        return self.executor.prewarm(manifest, exercise)

    def release(self) -> None:
        """Drop every cached program with its CUDA graphs and give their
        memory back to the card (``Executor.release``)."""
        self.executor.release()

    def submit(self, spec: QuerySpec, *args, strict: bool = False):
        """One request on the zero-sync steady path (``strict=True``
        forces the host-checked escalation loop)."""
        return self.executor.run(spec, *args, strict=strict)

    def submit_batch(self, requests: Sequence[Tuple],
                     strict: bool = False) -> list:
        """A mixed batch of (spec, *args) requests, in order."""
        return self.executor.run_batch(requests, strict=strict)

    # -- mutations (epoch-versioned mutable index, DESIGN.md §11) --------

    def insert(self, xs, ys):
        """Absorb a batch of new points into the resident index's delta
        buffers (no re-fit on this path: maintain() compacts a partition
        whose delta occupancy crossed the configured threshold). Returns
        the assigned point ids."""
        return self.executor.run(InsertBatch(), xs, ys)

    def delete(self, xs, ys) -> int:
        """Tombstone every live copy of each (x, y); returns the number
        of removed points. Queries stay exact at once."""
        return self.executor.run(DeleteBatch(), xs, ys)

    def refit(self, touched=None):
        """Compaction + per-partition spline re-fit now (e.g. in a
        maintenance window) instead of waiting for maintain()."""
        return self.executor.refit(touched)

    def maintain(self) -> dict:
        """Re-tune between batches: check the ok flags stashed by recent
        zero-sync runs, escalate overflowed sticky tiers and demote
        clean ones, and run the deferred re-fit that updates scheduled.
        Returns what moved. Call off the hot path."""
        return self.executor.maintain()

    def stats(self) -> dict:
        """Executor counters (Executor.stats): host_syncs, probe_syncs
        (one host read per bucketed wide call), dispatches, cache_size,
        compile_ms_total, the disk store's hits and misses, sticky,
        epoch, shape_epoch, updates, refits, pending_refit, ..."""
        return self.executor.stats()
