"""Query executor: runs QuerySpecs against one LearnedSpatialIndex on
one device.

Exact specs run one local program (core/local_ops.py): PointQuery ->
_PointLocal, RangeCount -> _RangeCountLocal, Knn(mode="exact") ->
_KnnExactLocal, SpatialJoin(mode="full") -> _JoinFullLocal.

Adaptive specs (RangeQuery, CircleQuery, pruned Knn, windowed
SpatialJoin) share one policy (paper §4, DESIGN.md §7), in
``_adaptive``:

* strict (``strict=True``, or no sticky tier yet): start from the spec
  family's sticky (cap, cand) tier (or the initial one), run the
  windowed program, read its ok flags on the host (``_all_ok``, counted
  in ``host_syncs``), escalate until every query is ok or the tier is
  maxed, then fall back to the exact program where the family has one.
  The tier that succeeded becomes the family's sticky tier, keyed by
  ``spec.sticky_key()``.
* serving (``strict=False`` on a sticky tier): one fused program
  (``local_ops._CondFusedLocal``) runs the windowed attempt at the
  sticky tier and the exact fallback on the device, with no host read;
  its ok flags are stashed, unread, for ``maintain()``, which re-tunes
  the tiers off the hot path (escalation, demotion, back-off).
* wide serving (``strict=False`` on a sticky tier, at least
  ``tier_bucket_min`` queries): the tier-bucketed dispatch
  (``_run_bucketed``, DESIGN.md §13). A need probe ranks every row on
  the device, one host read brings back the bucket sizes (counted in
  ``probe_syncs``, not ``host_syncs``), and each bucket runs the fused
  program at the lowest tier its rows fit, scattered back in request
  order: bitwise one sticky-tier call.

Update specs (InsertBatch, DeleteBatch, Refit; DESIGN.md §11) mutate
the resident index through the same ``run``: inserts append to the
partitions' delta buffers, deletes tombstone in place, and a re-fit
compacts the touched partitions (``core/mutate.py``). They are
host-driven and may read the host; a query after them still makes no
host read on the serving path. An update whose partition's delta
occupancy passes ``EngineConfig.delta_occupancy`` schedules a re-fit,
which ``maintain()`` runs off the hot path.

There is no compile cache: PyTorch runs eagerly, so ``shape_epoch`` is
tracked (it bumps where the reference's executables would be evicted)
but nothing is evicted.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch._num import (flush_denormals, mul_f32, resolve_device,
                              sub_f32)
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core import mutate as M
from repro_torch.core import queries as Q
from repro_torch.core.backends import resolve_backend
from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.plan import (CircleQuery, DeleteBatch, EngineConfig,
                                   InsertBatch, Knn, PointQuery, QuerySpec,
                                   RangeCount, RangeQuery, Refit,
                                   SpatialJoin)


@dataclasses.dataclass
class _AdaptiveOp:
    """Binds one query family to the adaptive policy."""
    base: Tuple                       # sticky key
    initial: Tuple[int, int]          # starting (cap, cand)
    window: Callable                  # (cap, cand) -> local program
    get_ok: Callable                  # raw result -> ok (Q,)
    finalize: Callable                # raw result -> public result
    escalate: Callable                # (cap, cand) -> (cap, cand)
    maxed: Callable                   # (cap, cand) -> bool
    sticky_on_maxed: bool             # the reference's per-family rule
    fallback: Optional[Callable]      # (pargs, raw) -> exact result
    fused: Callable                   # (cap, cand) -> fused program
    demote: Callable                  # (cap, cand) -> lower tier
    post: Callable = lambda r: r      # fused result -> public result
    # -- the tier-bucketed dispatch (DESIGN.md §13) --------------------
    probe: Optional[Callable] = None     # cand -> need probe program
    feasible: Optional[Callable] = None  # (probe, cap, cand) -> (Q,) bool
    owidth: Optional[Callable] = None    # (cap, cand) -> vid plane width
    bucketer: Optional[Callable] = None  # (probe, cap, cand) -> (Q,) rank


def _f32_const(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor of ``v`` on ``like``'s device (how the
    reference's weakly typed Python scalars enter float32 math), filled
    on the device: no host-to-device copy on the query path."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def _tree(fn, *outs):
    """``fn`` over the leaves of equal output structures (a tensor, or a
    tuple of tensors)."""
    if isinstance(outs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*outs))
    return fn(*outs)


def _pad_rows(args, n: int):
    """Each (rows, ...) tensor of ``args`` with its row 0 repeated ``n``
    more times at the end (a real query, so the padding runs the same
    program)."""
    return tuple(torch.cat([a, a[:1].expand((n,) + tuple(a.shape[1:]))])
                 for a in args)


class Executor:
    """Runs QuerySpecs against ``index`` on ``device`` (default: the
    card; "cpu" to run on the CPU). The index is padded to a multiple of
    ``config.part_chunk`` partitions and moved to the device."""

    def __init__(self, index: LearnedSpatialIndex,
                 config: Optional[EngineConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else EngineConfig()
        self.backend = resolve_backend(self.cfg.backend, self.device)
        index = L.pad_partitions(index.to(self.device), self.cfg.part_chunk)
        self.index = index
        self.parts = L.part_arrays(index)
        self.bounds = index.part_bounds          # (P, 4)
        self.spec = index.key_spec
        b = index.key_spec.bounds
        self.area = max((b[2] - b[0]) * (b[3] - b[1]), 1e-30)
        self._recount()
        # -- mutable-index state (DESIGN.md §11) -------------------------
        nxt = int(index.vid.max())
        if index.delta_vid is not None and index.delta_cap:
            nxt = max(nxt, int(index.delta_vid.max()))
        self.next_vid = nxt + 1
        self._refit_pending = set()  # partition ids awaiting compaction
        self.updates = 0      # applied insert/delete batches
        self.refits = 0       # refit_partitions invocations
        self._sticky = {}     # sticky_key -> last successful (cap, cand)
        self._initial = {}    # sticky_key -> initial (cap, cand), as the
                              # reference keeps it
        self._pending = {}    # sticky_key -> (tier, ok device tensor)
        self._escalators = {}  # sticky_key -> the op's escalate rule
        self._demoters = {}   # sticky_key -> the op's demote rule
        self._ok_streak = {}  # sticky_key -> consecutive clean checks
        self._demoted_from = {}   # sticky_key -> tier last demoted FROM
        self._demote_backoff = {}  # sticky_key -> streak multiplier
        self.host_syncs = 0   # counted host reads of ok (_all_ok)
        self.probe_syncs = 0  # host reads of a bucketed call's sizes
        self.dispatches = 0   # local-program and update-program calls
        # serializes run, maintain and refit, so several threads can
        # share one executor (sticky state, stashed ok flags, the index);
        # reentrant because run(Refit) and maintain() call refit()
        self._lock = threading.RLock()

    def _f32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _i32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.int32).contiguous()
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _call(self, fn, *args):
        self.dispatches += 1
        return fn(self.parts, self.bounds, *args)

    def _all_ok(self, ok) -> bool:
        """The only counted host read of ``ok`` on the query path."""
        self.host_syncs += 1
        return bool(ok.all())

    # -- public entry points ---------------------------------------------

    def run(self, spec: QuerySpec, *args, strict: bool = False):
        """Execute one QuerySpec. ``strict=True`` runs the adaptive specs'
        host-checked escalation loop; ``strict=False`` runs serving mode
        once the family has a sticky tier (module docstring).
        Thread-safe."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"expected a QuerySpec, got {spec!r}")
        if len(args) != spec.n_args:
            raise TypeError(f"{type(spec).__name__} takes {spec.n_args} "
                            f"data arguments, got {len(args)}")
        with self._lock:
            if isinstance(spec, InsertBatch):
                return self._run_insert(args)
            if isinstance(spec, DeleteBatch):
                return self._run_delete(args)
            if isinstance(spec, Refit):
                return self.refit()
            if isinstance(spec, PointQuery):
                return self._run_point(args)
            if isinstance(spec, RangeCount):
                return self._run_range_count(args)
            if isinstance(spec, RangeQuery):
                return self._run_range(spec, args, strict)
            if isinstance(spec, CircleQuery):
                return self._run_circle(spec, args, strict)
            if isinstance(spec, Knn):
                return self._run_knn(spec, args, strict)
            if isinstance(spec, SpatialJoin):
                return self._run_join(spec, args, strict)
        raise TypeError(f"unknown QuerySpec: {spec!r}")

    def run_batch(self, requests, strict: bool = False) -> list:
        """Execute (spec, *args) tuples; results in request order. A
        steady batch (every adaptive family on a sticky tier) makes no
        host sync."""
        return [self.run(req[0], *req[1:], strict=strict)
                for req in requests]

    def maintain(self) -> dict:
        """Deferred re-tuning, off the serving hot path: read the ok
        flags that serving calls stashed; escalate a sticky tier that
        overflowed, and demote one that stayed clean for
        ``EngineConfig.demote_after`` consecutive checks. A demotion
        that the next overflow undoes (the escalation lands on the tier
        it left) doubles that family's required clean streak. Counts
        stay exact either way: an overflowed serving call already took
        the exact fallback on the device. Then the deferred compaction:
        the partitions whose delta occupancy an update pushed past
        ``EngineConfig.delta_occupancy`` are re-fit (reported under
        "refit"). Returns {sticky_key: new (cap, cand)} for the tiers
        that moved. Thread-safe."""
        with self._lock:
            return self._maintain_locked()

    def _maintain_locked(self) -> dict:
        moved = {}
        for base, (tier, ok) in list(self._pending.items()):
            del self._pending[base]
            if self._sticky.get(base) != tier:
                continue   # stale: the sticky tier moved since the stash
            if self._all_ok(ok):
                streak = self._ok_streak.get(base, 0) + 1
                self._ok_streak[base] = streak
                # the demoted tier survived a clean check: a real
                # demotion, so a later escalation through it is no bounce
                self._demoted_from.pop(base, None)
                need = (self.cfg.demote_after *
                        self._demote_backoff.get(base, 1))
                if streak < need:
                    continue
                new = self._demoters[base](*tier)
                if new != tier:
                    self._demoted_from[base] = tier
                    self._set_sticky(base, new)
                    moved[base] = new
                continue
            self._ok_streak[base] = 0
            new = self._escalators[base](*tier)
            if new != tier:
                if self._demoted_from.pop(base, None) == new:
                    # immediate bounce: back off, never veto for good
                    self._demote_backoff[base] = \
                        self._demote_backoff.get(base, 1) * 2
                self._set_sticky(base, new)
                moved[base] = new
        # deferred compaction + re-fit, scheduled by updates whose delta
        # occupancy crossed the threshold, run here off the hot path
        if self._refit_pending:
            done = self.refit(sorted(self._refit_pending))
            if done:
                moved["refit"] = done
        return moved

    def stats(self) -> dict:
        """Counters: host_syncs, probe_syncs, dispatches, backend, sticky
        tiers, the index's epoch and shape_epoch, applied updates and
        re-fits, and the partitions with a re-fit pending."""
        return {"host_syncs": self.host_syncs,
                "probe_syncs": self.probe_syncs,
                "dispatches": self.dispatches,
                "backend": self.backend.name,
                "sticky": dict(self._sticky),
                "epoch": self.index.epoch,
                "shape_epoch": self.index.shape_epoch,
                "updates": self.updates,
                "refits": self.refits,
                "pending_refit": sorted(self._refit_pending)}

    @property
    def epoch(self) -> int:
        """Mutation epoch of the resident index: a read dispatched after
        a write sees an epoch at least the write's."""
        return self.index.epoch

    def maintenance_due(self) -> bool:
        """Deferred maintain() work waiting: stashed ok flags of serving
        calls, or occupancy-scheduled re-fits."""
        return bool(self._pending) or bool(self._refit_pending)

    @property
    def precompiling(self) -> bool:
        """Whether a background precompile worker is running: never, as
        the port compiles no program per width or tier (warm start,
        ROADMAP item 16, brings the worker). The serve scheduler reads
        it to decide its batch width."""
        return False

    # -- the mutable index (DESIGN.md §11) ---------------------------------

    def _recount(self):
        """Refresh the live-point total and density (the kNN radius's
        global estimate): built points less tombstones plus live
        buffered inserts."""
        idx = self.index
        n = int(idx.count.sum())
        if idx.dead is not None:
            n -= int(idx.dead.sum())
        if idx.delta_vid is not None and idx.delta_cap:
            n += int((idx.delta_vid >= 0).sum())
        self.n_total = n
        self.density = max(n / self.area, 1e-30)

    def _install_index(self, new_index, leaves=None):
        """Swap in a mutated index: refresh the partition tensors (only
        ``leaves`` when given and the leaf set is unchanged: inserts
        never move the sorted data plane) and the boxes, and recount."""
        self.index = new_index
        names = L.part_leaf_names(new_index)
        if leaves is None or names != set(self.parts):
            leaves = names
        parts = dict(self.parts)
        parts.update(L.part_arrays(new_index, leaves=leaves))
        self.parts = {k: parts[k] for k in names}
        self.bounds = new_index.part_bounds
        self._recount()

    def _note_occupancy(self, touched):
        """Schedule the deferred re-fit of the touched partitions whose
        delta occupancy crossed the threshold (run by maintain())."""
        occ = M.delta_occupancy(self.index)
        for p in np.asarray(touched).tolist():
            if occ[p] > self.cfg.delta_occupancy:
                self._refit_pending.add(int(p))

    def _with_delta_state(self):
        """The index, given delta bookkeeping if it was built without."""
        if self.index.delta_count is None:
            self._install_index(M.with_delta_capacity(self.index, 0,
                                                      floor=0))
        return self.index

    def _run_insert(self, args):
        """InsertBatch: append to the target partitions' delta buffers.
        Returns the assigned vids (B,) int32, numpy. Host-driven like
        build_index: the capacity check reads the host."""
        xs, ys = self._f32(args[0]), self._f32(args[1])
        b = int(xs.shape[0])
        if b == 0:
            return np.zeros((0,), np.int32)
        idx = self._with_delta_state()
        pid = M.assign_insert(idx, xs, ys)
        # out-of-domain inserts land in the overflow grid; widen its box
        # so the global filter (rect, circle, kNN and join candidates)
        # sees them, not only the point probe, which always reads the
        # overflow grid. Keys still clip to key_spec.bounds; the refine
        # compares the stored coordinates, so answers stay exact. The
        # extremes are taken over the flushed coordinates, as XLA:CPU
        # compares them (a -1e-45 among others reads as -0.0).
        ob = idx.part_bounds[idx.overflow].cpu().numpy()
        fx, fy = flush_denormals(xs), flush_denormals(ys)
        nb = [min(ob[0], float(fx.min())), min(ob[1], float(fy.min())),
              max(ob[2], float(fx.max())), max(ob[3], float(fy.max()))]
        if nb != ob.tolist():
            pb = idx.part_bounds.clone()
            pb[idx.overflow] = torch.as_tensor(np.asarray(nb, np.float32),
                                               device=self.device)
            idx = dataclasses.replace(idx, part_bounds=pb)
            self._install_index(idx, leaves=())
        need = idx.delta_count.cpu().numpy() + np.bincount(
            pid.cpu().numpy(), minlength=idx.num_partitions)
        if int(need.max()) > idx.delta_cap:
            idx = M.with_delta_capacity(idx, int(need.max()),
                                        floor=self.cfg.delta_cap)
            self._install_index(idx)     # a new leaf set: full refresh
        key = K.make_keys(xs, ys, self.spec)
        vids = torch.arange(self.next_vid, self.next_vid + b,
                            dtype=torch.int32, device=self.device)
        self.dispatches += 1   # the update program, as the reference counts
        dk, dx, dy, dv, dc = M.scatter_inserts(
            idx.delta_key, idx.delta_x, idx.delta_y, idx.delta_vid,
            idx.delta_count, pid, key, xs, ys, vids)
        idx = dataclasses.replace(
            idx, delta_key=dk, delta_x=dx, delta_y=dy, delta_vid=dv,
            delta_count=dc, epoch=idx.epoch + 1)
        self.next_vid += b
        self.updates += 1
        self._install_index(idx, leaves=("dx", "dy", "dvid", "dcount"))
        self._note_occupancy(np.unique(pid.cpu().numpy()))
        return np.arange(self.next_vid - b, self.next_vid, dtype=np.int32)

    def _run_delete(self, args):
        """DeleteBatch: tombstone every live copy of each (x, y) in its
        two candidate partitions (main plane and delta). Returns the
        number of removed points."""
        xs, ys = self._f32(args[0]), self._f32(args[1])
        b = int(xs.shape[0])
        if b == 0:
            return 0
        idx = self._with_delta_state()
        pid1 = M.assign_insert(idx, xs, ys)
        pid2 = torch.full_like(pid1, idx.overflow)
        self.dispatches += 1
        nx, ny, nv, dx, dy, dv, dead2, removed = M.apply_deletes(
            idx.x, idx.y, idx.vid, idx.count, idx.delta_x, idx.delta_y,
            idx.delta_vid, idx.delta_count, idx.dead, xs, ys, pid1, pid2)
        idx = dataclasses.replace(
            idx, x=nx, y=ny, vid=nv, delta_x=dx, delta_y=dy,
            delta_vid=dv, dead=dead2, epoch=idx.epoch + 1)
        self.updates += 1
        leaves = ("x", "y", "vid")
        if idx.delta_cap:
            leaves = leaves + ("dx", "dy", "dvid")
        self._install_index(idx, leaves=leaves)
        self._note_occupancy(np.unique(np.append(pid1.cpu().numpy(),
                                                 idx.overflow)))
        return int(removed)

    def refit(self, touched=None):
        """Compaction + per-partition spline re-fit
        (``mutate.refit_partitions``): merge the delta buffers, drop
        tombstones and re-fit ONLY the given partitions (default: every
        dirty one). Returns the list of partition ids re-fit.
        Thread-safe."""
        with self._lock:
            return self._refit_locked(touched)

    def _refit_locked(self, touched=None):
        idx = self.index
        if idx.delta_count is None:
            return []
        if touched is None:
            touched = M.dirty_partitions(idx)
        touched = np.unique(np.asarray(touched, np.int32))
        if touched.size == 0:
            return []
        new = M.refit_partitions(idx, touched)
        self.refits += 1
        self._refit_pending.difference_update(int(t) for t in touched)
        self._install_index(new)         # the data plane moved: refresh
        # shed a burst-grown delta buffer once fully compacted (the 2x
        # floor hysteresis rate-limits grow/shrink ping-pong)
        idx2 = self.index
        if (idx2.delta_cap > 2 * max(self.cfg.delta_cap, 1)
                and M.dirty_partitions(idx2).size == 0):
            self._install_index(
                M.shrink_delta_capacity(idx2, self.cfg.delta_cap))
        return [int(t) for t in touched]

    # -- the adaptive policy ----------------------------------------------

    def _adaptive(self, op: _AdaptiveOp, pargs, strict: bool,
                  start: Optional[Tuple[int, int]] = None):
        """Sticky tier + geometric escalation + exact fallback, or the
        fused serving program. ``start`` is a one-off user tier: it runs
        the strict loop and never updates the sticky state."""
        self._initial.setdefault(op.base, op.initial)
        self._escalators[op.base] = op.escalate
        self._demoters[op.base] = op.demote
        sticky = self._sticky.get(op.base)
        if sticky is not None and not strict and start is None:
            if (self.cfg.tier_buckets and op.probe is not None
                    and pargs[0].shape[0] >= self.cfg.tier_bucket_min
                    and (op.feasible is not None
                         or op.bucketer is not None)):
                return self._run_bucketed(op, pargs, sticky)
            # steady state: the fused program, no host read; ok is
            # stashed, unread, for maintain()
            out, ok = self._call(op.fused(*sticky), *pargs)
            self._pending[op.base] = (sticky, ok)
            return op.post(out)
        cap, cand = start or sticky or op.initial
        while True:
            res = self._call(op.window(cap, cand), *pargs)
            hit = self._all_ok(op.get_ok(res))
            maxed = op.maxed(cap, cand)
            if hit or (maxed and op.sticky_on_maxed):
                if start is None:
                    self._set_sticky(op.base, (cap, cand))
                return op.finalize(res)
            if maxed:
                break
            cap, cand = op.escalate(cap, cand)
        return op.fallback(pargs, res)

    # -- the wide-batch tier-bucketed dispatch (DESIGN.md §13) -----------

    def _ladder_tiers(self, op: _AdaptiveOp, sticky) -> list:
        """The escalation ladder's tiers from the initial one up to the
        sticky tier, ascending; a sticky tier off the ladder gives the
        one sticky bucket (correctness never depends on the ladder)."""
        tiers = [op.initial]
        cur = op.initial
        while cur != sticky:
            nxt = op.escalate(*cur)
            if nxt == cur or len(tiers) > 64:
                return [sticky]
            cur = nxt
            tiers.append(cur)
        return tiers

    def _feasible_rect(self, materialize: bool) -> Callable:
        """The rect families' rule on the (Q, 3) need probe [ncand, need,
        needsum]: a feasible row is ok at the tier (its candidates are
        complete, every learned window fits cap, and, materializing, the
        keep width drops no id), so it gives the sticky tier's result
        there (up to the -1 padding ``_norm_width`` adds)."""
        n_pad = self.index.n_pad
        p_total = self.index.num_partitions
        d_cap = self.index.delta_cap

        def feasible(probe, cap, cand):
            cap_e = min(cap, n_pad)
            cand_e = min(cand, p_total)
            ok = (probe[:, 0] <= cand_e) & (probe[:, 1] <= cap_e)
            if materialize:
                ok = ok & ((probe[:, 2] + cand_e * d_cap)
                           <= max(cap_e * 8, 256))
            return ok

        return feasible

    def _owidth_rect(self) -> Callable:
        """The rect programs' materialized vid plane width at a tier:
        ``local_ops._keep_window``'s keep bound, so a light bucket pads
        to the sticky tier's width bitwise."""
        n_pad = self.index.n_pad
        p_total = self.index.num_partitions
        d_cap = self.index.delta_cap

        def owidth(cap, cand):          # one device: one partition shard
            cap_e = min(cap, n_pad)
            cand_e = min(cand, p_total)
            return min(cand_e * (4 * cap_e + d_cap), max(cap_e * 8, 256))

        return owidth

    def _knn_bucketer(self, k: int) -> Callable:
        """Rank kNN rows by their predicted resolving round on the
        (Q, J, 3) need probe [need, tot, nin], on the device: rows whose
        candidate mass reaches 2k within the probed rounds (and whose
        window fits the sticky cap and cand) rank 0 (round 0 or 1) or 1;
        the rest rank 2, the hard bucket. Every rank runs at the sticky
        tier: the ranks split padded widths, never values."""
        n_pad = self.index.n_pad
        cand = min(self.cfg.knn_cand, self.index.num_partitions)
        j_max = L._KnnNeedLocal.J

        def bucketer(probe, cap, _cand):
            cap_e = min(cap, n_pad)
            need, tot, nin = probe[..., 0], probe[..., 1], probe[..., 2]
            enough = tot >= 2 * k                       # (Q, J)
            # argmax: the first round with enough mass
            jest = torch.where(enough.any(1),
                               enough.to(torch.int32).argmax(1), j_max)
            jc = torch.clamp(jest, max=j_max - 1)[:, None]
            hard = ((jest >= j_max) | (need.gather(1, jc)[:, 0] > cap_e)
                    | (nin.gather(1, jc)[:, 0] > cand))
            return torch.where(hard, 2, torch.where(jest <= 1, 0, 1))

        return bucketer

    def _norm_width(self, op: _AdaptiveOp, out, tier, sticky):
        """-1-pad a light bucket's materialized vid plane to the sticky
        tier's width (both are -1 past the kept ids, so the padded plane
        is the sticky run's bit for bit)."""
        if op.owidth is None or tier == sticky:
            return out
        pad = op.owidth(*sticky) - out[1].shape[1]
        if pad <= 0:
            return out
        vids = torch.nn.functional.pad(out[1], (0, pad), value=-1)
        return (out[0], vids) + tuple(out[2:])

    def _row_chunk(self, tier, width: int) -> int:
        """Most rows per fused call at ``tier``: rows x (cap * cand)
        stays within ``row_chunk_elems``, a power of two (it tiles the
        power-of-two buckets, so every chunk has one shape) of at least
        256 rows."""
        per_row = max(1, int(tier[0]) * int(tier[1]))
        cw = max(1, self.cfg.row_chunk_elems // per_row)
        cw = max(256, 1 << (cw.bit_length() - 1))
        return min(width, cw)

    def _fused_chunked(self, op: _AdaptiveOp, tier, bargs, width: int):
        """``bargs`` (width rows) through the tier's fused program in
        ``_row_chunk``-row slices, (out, ok) concatenated. Each output row
        is a function of its row and the tier, so the result is one
        call's. A short tail chunk is padded with its own row 0 (a real
        query) to the chunk width and un-padded."""
        cw = self._row_chunk(tier, width)
        fn = op.fused(*tier)
        if cw >= width:
            return self._call(fn, *bargs)
        outs, oks = [], []
        for s in range(0, width, cw):
            cargs = tuple(a[s:s + cw] for a in bargs)
            tail = cw - cargs[0].shape[0]
            if tail > 0:
                cargs = _pad_rows(cargs, tail)
            out, ok = self._call(fn, *cargs)
            if tail > 0:
                out, ok = _tree(lambda a: a[:-tail], out), ok[:-tail]
            outs.append(out)
            oks.append(ok)
        return (_tree(lambda *a: torch.cat(a), *outs), torch.cat(oks))

    def _run_bucketed(self, op: _AdaptiveOp, pargs, sticky):
        """The wide-batch tier-bucketed dispatch (DESIGN.md §13).

        The need probe ranks every row on the device: rect-family rows
        at the lowest ladder tier where the probe guarantees a fit (if
        they fit at the sticky tier too; otherwise a hard bucket at the
        sticky tier, where a serial call would run them), kNN rows by
        predicted resolving round, all at the sticky tier. One host read
        brings back the bucket sizes (``probe_syncs``, not
        ``host_syncs``: the zero-sync contract concerns the ok flags).
        Each bucket's rows, in request order, are padded to a power of
        two with its own row 0 and run through the fused program of its
        tier; the outputs scatter back by the inverse permutation. Each
        output row depends only on (row, tier), so the result is one
        sticky-tier call's, bit for bit."""
        qn = pargs[0].shape[0]
        cand_p = (self.cfg.knn_cand if op.bucketer is not None
                  else sticky[1])
        probe = self._call(op.probe(cand_p), *pargs)
        if op.bucketer is not None:
            rank = op.bucketer(probe, *sticky)
            tier_of = [sticky] * 3
        else:
            tier_of = self._ladder_tiers(op, sticky)
            nb = len(tier_of)
            rank = torch.full((qn,), nb - 1, dtype=torch.int64,
                              device=probe.device)
            for i in reversed(range(nb - 1)):
                rank = torch.where(op.feasible(probe, *tier_of[i]), i, rank)
            # rows not guaranteed at the sticky tier: a hard bucket there,
            # so the exact fallback fires on it alone
            rank = torch.where(op.feasible(probe, *sticky), rank, nb)
            tier_of = tier_of + [sticky]
        sizes = torch.zeros(len(tier_of), dtype=torch.int64,
                            device=rank.device)
        sizes.scatter_add_(0, rank, torch.ones_like(rank))
        sizes = sizes.tolist()          # the one host read of the call
        self.probe_syncs += 1
        present = [rk for rk, n in enumerate(sizes) if n]
        if len(present) == 1 and tier_of[present[0]] == sticky:
            # one bucket at the sticky tier: still row-chunked
            out, ok = self._fused_chunked(op, sticky, pargs, qn)
            self._pending[op.base] = (sticky, ok)
            return op.post(out)
        # rows grouped by rank, each group in request order
        perm = torch.sort(rank, stable=True).indices
        outs, oks, lo = [], [], 0
        for rk in present:
            bl = sizes[rk]
            sel = perm[lo:lo + bl]
            lo += bl
            tier = tier_of[rk]
            plen = 1 << (bl - 1).bit_length()
            bargs = tuple(a.index_select(0, sel) for a in pargs)
            if plen > bl:
                bargs = _pad_rows(bargs, plen - bl)
            out, ok = self._fused_chunked(op, tier, bargs, plen)
            if plen > bl:
                out, ok = _tree(lambda a: a[:bl], out), ok[:bl]
            outs.append(self._norm_width(op, out, tier, sticky))
            oks.append(ok)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(qn, device=perm.device)
        merged = _tree(lambda *a: torch.cat(a).index_select(0, inv), *outs)
        ok_all = torch.cat(oks).index_select(0, inv)
        self._pending[op.base] = (sticky, ok_all)
        return op.post(merged)

    def _set_sticky(self, base, variant):
        old = self._sticky.get(base)
        self._sticky[base] = variant
        if old != variant:
            # a new tier starts its demotion clock from zero
            self._ok_streak[base] = 0

    def _maxed_both(self, cap, cand):
        return (cap >= self.index.n_pad and
                cand >= self.index.num_partitions)

    def _escalate_both(self, cap, cand):
        return (min(cap * 4, self.index.n_pad),
                min(cand * 2, self.index.num_partitions))

    def _ladder_demote(self, initial, escalate):
        """Demote to the PREDECESSOR on the op's escalation ladder
        (initial, escalate(initial), ...), not to an arithmetic inverse,
        which lands off the ladder where escalation clamped."""
        def demote(cap, cand):
            prev = cur = initial
            for _ in range(64):          # ladders are O(log) long
                if cur == (cap, cand):
                    return prev
                nxt = escalate(*cur)
                if nxt == cur:
                    break                # maxed without finding it
                prev, cur = cur, nxt
            return (cap, cand)           # off-ladder: stay put
        return demote

    # -- per-kind preparation and dispatch ------------------------------

    def _rect_keys(self, rects):
        klo, khi = K.rect_key_range(rects, self.spec)
        return K.keys_to_f32(klo), K.keys_to_f32(khi)

    def _run_point(self, args):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        qk = K.keys_to_f32(K.make_keys(qx, qy, self.spec))
        fn = L._PointLocal(self.index, self.cfg, self.backend)
        return self._call(fn, qx, qy, qk) > 0

    def _run_range_count(self, args):
        rects = self._f32(args[0]).reshape(-1, 4)
        klo, khi = self._rect_keys(rects)
        fn = L._RangeCountLocal(self.index, self.cfg, self.backend)
        return self._call(fn, rects, klo, khi)

    def _op_range(self, base):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def fused(cap, cand):
            # counts stay exact via the exact range count; ok still
            # flags each query's materialization completeness
            return L._CondFusedLocal(
                idx, cfg, bk,
                primary=L._RangeWindowLocal(idx, cfg, bk, cap, cand),
                fallback=L._RangeCountLocal(idx, cfg, bk),
                fb_args=(0, 1, 2),
                get_ok=lambda pri: pri[2],
                merge_ok=lambda pri: pri,
                merge_fb=lambda pri, fb: (fb, pri[1], pri[2]))

        return _AdaptiveOp(
            base=base, initial=(cfg.range_cap, cfg.range_cand),
            window=lambda cap, cand: L._RangeWindowLocal(idx, cfg, bk,
                                                         cap, cand),
            get_ok=lambda res: res[2], finalize=lambda res: res,
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=True, fallback=None, fused=fused,
            demote=self._ladder_demote((cfg.range_cap, cfg.range_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[0], 3),
            feasible=self._feasible_rect(True),
            owidth=self._owidth_rect())

    def _run_range(self, spec: RangeQuery, args, strict):
        rects = self._f32(args[0]).reshape(-1, 4)
        klo, khi = self._rect_keys(rects)
        op = self._op_range(spec.sticky_key())
        start = None
        if spec.cap is not None:
            # the user cap overrides the starting tier; cand follows sticky
            _, cand0 = self._sticky.get(op.base, op.initial)
            start = (min(spec.cap, self.index.n_pad), cand0)
        return self._adaptive(op, (rects, klo, khi), strict, start=start)

    def _circle_args(self, args):
        """(rects, klo, khi, circ) of (cx, cy, r): the circles' MBRs and
        their key ranges, and the (Q, 3) circles."""
        cx, cy, r = (self._f32(a) for a in args)
        rects = Q.circle_mbrs(cx, cy, r)
        klo, khi = self._rect_keys(rects)
        return rects, klo, khi, torch.stack([cx, cy, r], -1)

    def _circle_exact(self, pargs):
        """Exact in-circle counts: the full-refine program behind the
        adaptive circle query (the reference's fallback program)."""
        return self._call(L._CircleCountLocal(self.index, self.cfg,
                                              self.backend), *pargs)

    def _op_circle(self, base, materialize: bool):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def window(cap, cand):
            return L._CircleWindowLocal(idx, cfg, bk, cap, cand,
                                        materialize)

        def fused(cap, cand):
            if materialize:
                return L._CondFusedLocal(
                    idx, cfg, bk, primary=window(cap, cand),
                    fallback=L._CircleCountLocal(idx, cfg, bk),
                    fb_args=(0, 1, 2, 3),
                    get_ok=lambda pri: pri[2],
                    merge_ok=lambda pri: pri,
                    merge_fb=lambda pri, fb: (fb, pri[1], pri[2]))
            return L._CondFusedLocal(
                idx, cfg, bk, primary=window(cap, cand),
                fallback=L._CircleCountLocal(idx, cfg, bk),
                fb_args=(0, 1, 2, 3),
                get_ok=lambda pri: pri[1],
                merge_ok=lambda pri: pri[0],
                merge_fb=lambda pri, fb: fb)

        def fallback(pargs, res):
            cnt = self._circle_exact(pargs)
            if materialize:    # exact counts; window ids flagged by ok
                return cnt, res[1], res[2]
            return cnt

        return _AdaptiveOp(
            base=base, initial=(cfg.circle_cap, cfg.circle_cand),
            window=window, get_ok=lambda res: res[-1],
            finalize=(lambda res: res) if materialize
            else (lambda res: res[0]),
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False, fallback=fallback, fused=fused,
            demote=self._ladder_demote((cfg.circle_cap, cfg.circle_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[0], 4),
            feasible=self._feasible_rect(materialize),
            owidth=self._owidth_rect() if materialize else None)

    def _run_circle(self, spec: CircleQuery, args, strict):
        op = self._op_circle(spec.sticky_key(), spec.materialize)
        return self._adaptive(op, self._circle_args(args), strict)

    def _knn_r0(self, qx, qy, k):
        """Initial radius per query (paper Eq. (1), r = sqrt(k / (pi d)),
        with the local density of each query's nearest partition), in
        the reference's dtypes and order: the global estimate in float64
        on the host, the rest in float32, the box distance unfused (the
        reference runs it eagerly, outside any compiled program). XLA's
        eager ops read denormals as zero and flush tiny results too."""
        r0g = float(np.sqrt(max(k, 1) / (np.pi * self.density)))
        zero = _f32_const(0.0, qx)
        b = flush_denormals(self.bounds)
        dx = torch.maximum(torch.maximum(b[:, 0] - qx[:, None],
                                         qx[:, None] - b[:, 2]), zero)
        dy = torch.maximum(torch.maximum(b[:, 1] - qy[:, None],
                                         qy[:, None] - b[:, 3]), zero)
        # the differences are only squared, and a sum of two flushed
        # squares is 0 or at least 2^-126: no flush needed there
        pid0 = torch.argmin(mul_f32(dx, dx) + mul_f32(dy, dy), dim=1)
        b0 = b[pid0]
        area0 = torch.maximum(mul_f32(sub_f32(b0[:, 2], b0[:, 0]),
                                      sub_f32(b0[:, 3], b0[:, 1])),
                              _f32_const(1e-30, qx))
        d0 = torch.maximum(self.index.count[pid0] / area0,
                           _f32_const(1e-30, qx))
        r0 = torch.sqrt(_f32_const(k, qx) / (_f32_const(np.pi, qx) * d0))
        return torch.maximum(r0, _f32_const(r0g, qx))

    def _knn_exact(self, k, qx, qy):
        fn = L._KnnExactLocal(self.index, self.cfg, self.backend, k)
        return self._call(fn, qx, qy)

    def _op_knn(self, base, k):
        idx, cfg, bk = self.index, self.cfg, self.backend
        cand = cfg.knn_cand

        def fused(cap, _cand):
            def pruned(c):      # the serving form: fixed rounds
                return L._KnnPrunedLocal(idx, cfg, bk, k, cand, c,
                                         fixed_rounds=True)

            def merge_fb(pri, fb):
                okc = pri[2][:, None]
                return (torch.where(okc, pri[0], fb[0]),
                        torch.where(okc, pri[1], fb[1]))

            # fallback ladder: overflowed rows retry at the next cap
            # before the exact scan
            exact = L._KnnExactLocal(idx, cfg, bk, k)
            esc = min(cap * 4, idx.n_pad)
            if esc > cap:
                fb = L._KnnLadderLocal(idx, cfg, bk, primary=pruned(esc),
                                       exact=exact)
                fb_args = (0, 1, 2)
            else:
                fb, fb_args = exact, (0, 1)
            return L._CondFusedLocal(
                idx, cfg, bk, primary=pruned(cap), fallback=fb,
                fb_args=fb_args, get_ok=lambda pri: pri[2],
                merge_ok=lambda pri: (pri[0], pri[1]), merge_fb=merge_fb)

        def fallback(pargs, res):
            # unresolved queries: the exact scan
            neg, vid, ok = res
            nege, vide = self._knn_exact(k, *pargs[:2])
            okc = ok[:, None]
            return (torch.where(okc, -neg, -nege),
                    torch.where(okc, vid, vide))

        return _AdaptiveOp(
            base=base, initial=(cfg.knn_cap, cand),
            window=lambda cap, _cand: L._KnnPrunedLocal(
                idx, cfg, bk, k, cand, cap),
            get_ok=lambda res: res[2],
            finalize=lambda res: (-res[0], res[1]),
            escalate=lambda cap, cd: (min(cap * 4, idx.n_pad), cd),
            maxed=lambda cap, cd: cap >= idx.n_pad,
            sticky_on_maxed=False, fallback=fallback, fused=fused,
            post=lambda r: (-r[0], r[1]),
            demote=lambda cap, cd: (max(cap // 4, cfg.knn_cap), cd),
            probe=lambda c: L._KnnNeedLocal(idx, cfg, bk, c),
            bucketer=self._knn_bucketer(k))

    def _run_knn(self, spec: Knn, args, strict):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        if spec.mode == "exact":
            neg, vid = self._knn_exact(spec.k, qx, qy)
            return -neg, vid
        r0 = self._knn_r0(qx, qy, spec.k)
        op = self._op_knn(spec.sticky_key(), spec.k)
        return self._adaptive(op, (qx, qy, r0), strict)

    def _join_full(self, pargs):
        return self._call(L._JoinFullLocal(self.index, self.cfg,
                                           self.backend), *pargs)

    def _op_join(self, base):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def fused(cap, cand):
            return L._CondFusedLocal(
                idx, cfg, bk,
                primary=L._JoinLocal(idx, cfg, bk, cap, cand),
                fallback=L._JoinFullLocal(idx, cfg, bk),
                fb_args=(0, 1, 2),
                get_ok=lambda pri: pri[1],
                merge_ok=lambda pri: pri[0],
                merge_fb=lambda pri, fb: fb)

        return _AdaptiveOp(
            base=base, initial=(cfg.join_cap, cfg.join_cand),
            window=lambda cap, cand: L._JoinLocal(idx, cfg, bk, cap, cand),
            get_ok=lambda res: res[1], finalize=lambda res: res[0],
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False,
            fallback=lambda pargs, res: self._join_full(pargs), fused=fused,
            demote=self._ladder_demote((cfg.join_cap, cfg.join_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[2][:, :4], 3,
                                               z_depth=3),
            feasible=self._feasible_rect(False))

    def _join_args(self, args):
        """(polys, n_edges, mbr_k) of (polys, n_edges): mbr_k (PG, 6) holds
        each polygon's MBR over its first n_edges vertices and the MBR's
        key range."""
        polys = self._f32(args[0])
        n_edges = self._i32(args[1])
        em = L._edge_mask(polys, n_edges)
        big = _f32_const(3e38, polys)
        mbrs = torch.cat([torch.where(em, polys, big).amin(1),
                          torch.where(em, polys, -big).amax(1)], -1)
        klo, khi = self._rect_keys(mbrs)
        return polys, n_edges, torch.cat([mbrs, klo[:, None], khi[:, None]],
                                         -1)

    def _run_join(self, spec: SpatialJoin, args, strict):
        pargs = self._join_args(args)
        if spec.mode == "full":
            return self._join_full(pargs)
        return self._adaptive(self._op_join(spec.sticky_key()), pargs,
                              strict)
