"""Query executor: runs QuerySpecs against one LearnedSpatialIndex on
one device.

This slice runs the exact specs, each through one local program
(core/local_ops.py): PointQuery -> _PointLocal, RangeCount ->
_RangeCountLocal, Knn(mode="exact") -> _KnnExactLocal. The adaptive
specs raise NotImplementedError until their programs are ported. There
is no compile cache: PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._num import resolve_device
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core.backends import resolve_backend
from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.plan import (PENDING, EngineConfig, Knn, PointQuery,
                                   QuerySpec, RangeCount)


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

    def _f32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _call(self, fn, *args):
        self.dispatches += 1
        return fn(self.parts, self.bounds, *args)

    # -- public entry points ---------------------------------------------

    def run(self, spec: QuerySpec, *args, strict: bool = False):
        """Execute one QuerySpec. ``strict`` is accepted for the
        reference's signature; the exact specs need no escalation."""
        del strict
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"expected a QuerySpec, got {spec!r}")
        if len(args) != spec.n_args:
            raise TypeError(f"{type(spec).__name__} takes {spec.n_args} "
                            f"data arguments, got {len(args)}")
        if isinstance(spec, PointQuery):
            return self._run_point(args)
        if isinstance(spec, RangeCount):
            return self._run_range_count(args)
        if isinstance(spec, Knn) and spec.mode == "exact":
            return self._run_knn_exact(spec.k, args)
        raise NotImplementedError(
            f"{spec!r} is not ported yet: it needs {PENDING}")

    def run_batch(self, requests, strict: bool = False) -> list:
        """Execute (spec, *args) tuples; results in request order."""
        return [self.run(req[0], *req[1:], strict=strict)
                for req in requests]

    # -- per-kind drivers -------------------------------------------------

    def _run_point(self, args):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        qk = K.keys_to_f32(K.make_keys(qx, qy, self.spec))
        fn = L._PointLocal(self.index, self.cfg, self.backend)
        return self._call(fn, qx, qy, qk) > 0

    def _run_range_count(self, args):
        rects = self._f32(args[0]).reshape(-1, 4)
        klo, khi = K.rect_key_range(rects, self.spec)
        fn = L._RangeCountLocal(self.index, self.cfg, self.backend)
        return self._call(fn, rects, K.keys_to_f32(klo), K.keys_to_f32(khi))

    def _run_knn_exact(self, k, args):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        fn = L._KnnExactLocal(self.index, self.cfg, self.backend, k)
        neg, vid = self._call(fn, qx, qy)
        return -neg, vid
