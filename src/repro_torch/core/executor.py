"""Query executor: runs QuerySpecs against one LearnedSpatialIndex on
one device.

Exact specs run one local program (core/local_ops.py): PointQuery ->
_PointLocal, RangeCount -> _RangeCountLocal, Knn(mode="exact") ->
_KnnExactLocal, SpatialJoin(mode="full") -> _JoinFullLocal.

Adaptive specs (RangeQuery, CircleQuery, pruned Knn, windowed
SpatialJoin) run the reference's strict policy (paper §4, DESIGN.md §7)
once, in ``_adaptive``: start from the spec family's sticky (cap, cand)
tier (or the initial one), run the windowed program, read its ok flags
on the host, escalate until every query is ok or the tier is maxed,
then fall back to the exact program where the family has one. The tier
that succeeded becomes the family's sticky tier, keyed by
``spec.sticky_key()``, so a later call starts there.

``strict=False`` is the reference's serving mode: once a sticky tier
exists it runs a fused windowed + on-device fallback program whose ids
and ok flags differ from the strict loop's. That mode is not ported
(ROADMAP.md module item 12): with a sticky tier, ``strict=False``
raises NotImplementedError; with none yet, it runs the strict loop, as
the reference does. There is no compile cache: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch._num import resolve_device
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core.backends import resolve_backend
from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.plan import (PENDING, CircleQuery, EngineConfig, Knn,
                                   PointQuery, QuerySpec, RangeCount,
                                   RangeQuery, SpatialJoin)


@dataclasses.dataclass
class _AdaptiveOp:
    """Binds one query family to the strict policy loop."""
    base: Tuple                       # sticky key
    initial: Tuple[int, int]          # starting (cap, cand)
    window: Callable                  # (cap, cand) -> local program
    get_ok: Callable                  # raw result -> ok (Q,)
    finalize: Callable                # raw result -> public result
    escalate: Callable                # (cap, cand) -> (cap, cand)
    maxed: Callable                   # (cap, cand) -> bool
    sticky_on_maxed: bool             # the reference's per-family rule
    fallback: Optional[Callable]      # (pargs, raw) -> exact result


def _f32_const(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor of ``v`` on ``like``'s device (how the
    reference's weakly typed Python scalars enter float32 math)."""
    return torch.tensor(np.float32(v), device=like.device)


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
        self.n_total = int(index.count.sum())
        self.density = max(self.n_total / self.area, 1e-30)
        self.dispatches = 0   # local-program calls
        self._sticky = {}     # sticky_key -> last successful (cap, cand)

    def _f32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _call(self, fn, *args):
        self.dispatches += 1
        return fn(self.parts, self.bounds, *args)

    # -- public entry points ---------------------------------------------

    def run(self, spec: QuerySpec, *args, strict: bool = False):
        """Execute one QuerySpec. ``strict=True`` runs the adaptive specs'
        host-checked escalation loop; see the module docstring for
        ``strict=False``."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"expected a QuerySpec, got {spec!r}")
        if len(args) != spec.n_args:
            raise TypeError(f"{type(spec).__name__} takes {spec.n_args} "
                            f"data arguments, got {len(args)}")
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
        """Execute (spec, *args) tuples; results in request order."""
        return [self.run(req[0], *req[1:], strict=strict)
                for req in requests]

    # -- the strict adaptive policy ---------------------------------------

    def _adaptive(self, op: _AdaptiveOp, pargs, strict: bool,
                  start: Optional[Tuple[int, int]] = None):
        """Sticky tier + geometric escalation + exact fallback. ``start``
        is a one-off user tier: it never updates the sticky state."""
        sticky = self._sticky.get(op.base)
        if sticky is not None and not strict and start is None:
            raise NotImplementedError(
                f"strict=False on the sticky tier {sticky} of {op.base} is "
                f"not ported yet: it needs {PENDING}; pass strict=True")
        cap, cand = start or sticky or op.initial
        while True:
            res = self._call(op.window(cap, cand), *pargs)
            hit = bool(op.get_ok(res).all())     # the host read per tier
            maxed = op.maxed(cap, cand)
            if hit or (maxed and op.sticky_on_maxed):
                if start is None:
                    self._set_sticky(op.base, (cap, cand))
                return op.finalize(res)
            if maxed:
                break
            cap, cand = op.escalate(cap, cand)
        return op.fallback(pargs, res)

    def _set_sticky(self, base, variant):
        self._sticky[base] = variant

    def _maxed_both(self, cap, cand):
        return (cap >= self.index.n_pad and
                cand >= self.index.num_partitions)

    def _escalate_both(self, cap, cand):
        return (min(cap * 4, self.index.n_pad),
                min(cand * 2, self.index.num_partitions))

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
        return _AdaptiveOp(
            base=base, initial=(cfg.range_cap, cfg.range_cand),
            window=lambda cap, cand: L._RangeWindowLocal(idx, cfg, bk,
                                                         cap, cand),
            get_ok=lambda res: res[2], finalize=lambda res: res,
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=True, fallback=None)

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
        rects = torch.stack([cx - r, cy - r, cx + r, cy + r], -1)
        klo, khi = self._rect_keys(rects)
        return rects, klo, khi, torch.stack([cx, cy, r], -1)

    def _circle_exact(self, pargs):
        """Exact in-circle counts: the full-refine program behind the
        adaptive circle query (the reference's fallback program)."""
        return self._call(L._CircleCountLocal(self.index, self.cfg,
                                              self.backend), *pargs)

    def _op_circle(self, base, materialize: bool):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def fallback(pargs, res):
            cnt = self._circle_exact(pargs)
            if materialize:    # exact counts; window ids flagged by ok
                return cnt, res[1], res[2]
            return cnt

        return _AdaptiveOp(
            base=base, initial=(cfg.circle_cap, cfg.circle_cand),
            window=lambda cap, cand: L._CircleWindowLocal(
                idx, cfg, bk, cap, cand, materialize),
            get_ok=lambda res: res[-1],
            finalize=(lambda res: res) if materialize
            else (lambda res: res[0]),
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False, fallback=fallback)

    def _run_circle(self, spec: CircleQuery, args, strict):
        op = self._op_circle(spec.sticky_key(), spec.materialize)
        return self._adaptive(op, self._circle_args(args), strict)

    def _knn_r0(self, qx, qy, k):
        """Initial radius per query (paper Eq. (1), r = sqrt(k / (pi d)),
        with the local density of each query's nearest partition), in
        the reference's dtypes and order: the global estimate in float64
        on the host, the rest in float32, the box distance unfused (the
        reference runs it eagerly, outside any compiled program)."""
        r0g = float(np.sqrt(max(k, 1) / (np.pi * self.density)))
        zero = _f32_const(0.0, qx)
        b = self.bounds
        dx = torch.maximum(torch.maximum(b[:, 0] - qx[:, None],
                                         qx[:, None] - b[:, 2]), zero)
        dy = torch.maximum(torch.maximum(b[:, 1] - qy[:, None],
                                         qy[:, None] - b[:, 3]), zero)
        pid0 = torch.argmin(dx * dx + dy * dy, dim=1)   # first minimum
        b0 = b[pid0]
        area0 = torch.maximum((b0[:, 2] - b0[:, 0]) * (b0[:, 3] - b0[:, 1]),
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
            sticky_on_maxed=False, fallback=fallback)

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
        return _AdaptiveOp(
            base=base, initial=(cfg.join_cap, cfg.join_cand),
            window=lambda cap, cand: L._JoinLocal(idx, cfg, bk, cap, cand),
            get_ok=lambda res: res[1], finalize=lambda res: res[0],
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False,
            fallback=lambda pargs, res: self._join_full(pargs))

    def _join_args(self, args):
        """(polys, n_edges, mbr_k) of (polys, n_edges): mbr_k (PG, 6) holds
        each polygon's MBR over its first n_edges vertices and the MBR's
        key range."""
        polys = self._f32(args[0])
        n_edges = torch.as_tensor(args[1]).to(device=self.device,
                                              dtype=torch.int32)
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
