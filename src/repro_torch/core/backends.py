"""Kernel backends for the local query programs.

Every local program in ``core/local_ops.py`` is staged:

  lookup   learned key search — lower bounds ([s, e) intervals or probe
           positions) against a chunk of partitions;
  scan     the per-partition point work inside those bounds;
  merge    the cross-partition reduction — owned by the program.

A backend supplies lookup and scan, and the point program whole
(``point_query``: its candidates, lookup, scan and merge are one kernel
on the cuda backend). Lookup and scan take a whole chunk of
partitions per call (every leaf has a leading partition axis), so one
kernel launch covers the chunk: the kernels put the partition axis in
their grid.

  torch   the plain PyTorch stages (the kernels' plain versions), on any
          device; bitwise the JAX package's ``xla`` backend.
  cuda    routes lower_bound, range_scan, circle_scan, knn_scan and
          join_scan to the hand-written CUDA kernels in
          ``repro_torch/kernels``, and the point program whole
          (point_query: candidates, lookup, scan and merge) to one
          kernel launch.

The windowed programs' gathers (``core/queries.py``) are plain PyTorch
under both backends, as the reference keeps them on the XLA gather path.

``resolve_backend("auto", device)`` picks cuda on a CUDA device and torch
on the CPU. ``torch`` on a CUDA device is allowed: it is how a kernel is
held against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch._num import stable_topk
from repro_torch.core.plan import BACKENDS
from repro_torch.kernels import circle_filter as _cf
from repro_torch.kernels import knn_topk as _knn
from repro_torch.kernels import point_in_polygon as _pip
from repro_torch.kernels import point_probe as _pp
from repro_torch.kernels import range_filter as _rf
from repro_torch.kernels import spline_search as _ss


def _lookup_args(ch):
    return (ch["knot_keys"], ch["knot_pos"], ch["radix_table"],
            ch["keys_f"], ch["radix_kmin"], ch["radix_scale"],
            ch["n_knots"], ch["count"])


def _map_vid(vid, neg, idx):
    """Kernel positions -> point ids; empty slots (NEG) -> -1."""
    c, n_pad = vid.shape
    safe = idx.clamp(0, n_pad - 1).to(torch.int64).reshape(c, -1)
    out = torch.gather(vid, 1, safe).reshape(idx.shape)
    return torch.where((idx >= 0) & (neg > _knn.NEG), out, -1)


def _active(active, s):
    """The kernels' (C, Q) active flags: all pairs when None."""
    if active is None:
        return torch.ones(s.shape, dtype=torch.bool, device=s.device)
    return active.contiguous()


class TorchBackend:
    """Plain PyTorch lookup/scan stages (CPU or GPU)."""

    name = "torch"

    # -- lookup stage -----------------------------------------------------

    def lower_bound(self, ch, qkf, *, radix_bits: int, probe: int):
        """(C, Q) int32 exact learned lower bounds of (Q,) keys."""
        return _ss.spline_search_plain(qkf, *_lookup_args(ch), probe=probe,
                                       radix_bits=radix_bits)

    def bounds(self, ch, klo_f, khi_f, *, radix_bits: int, probe: int):
        """[s, e) covering all keys in [klo, khi]: (C, Q) int32 each
        (both ends share one lookup call)."""
        qn = klo_f.shape[0]
        pos = self.lower_bound(ch, torch.cat([klo_f, khi_f + 1.0]),
                               radix_bits=radix_bits, probe=probe)
        return pos[:, :qn].contiguous(), pos[:, qn:].contiguous()

    # -- scan stage -------------------------------------------------------

    def filter_mask(self, ch, rects, s, e, active=None):
        """(C, Q, n_pad) bool — in [s, e) AND in rect AND valid."""
        return _rf.range_mask(rects, s, e, ch["count"], ch["x"], ch["y"],
                              active)

    def range_scan(self, ch, rects, s, e, active=None):
        """(C, Q) exact in-rect counts within learned [s, e)."""
        return _rf.range_count_plain(rects, s, e, active, ch["count"],
                                     ch["x"], ch["y"])

    def circle_scan(self, ch, rects, s, e, circ, active=None):
        """(C, Q) exact in-circle counts (MBR filter + distance refine)
        within learned [s, e)."""
        return _cf.circle_count_plain(rects, s, e, circ, active,
                                      ch["count"], ch["x"], ch["y"])

    def join_scan(self, ch, polys, n_edges, mbrs, s, e, active=None):
        """(C, PG) per-polygon contained-point counts within learned
        [s, e) (MBR filter + ray casting)."""
        return _pip.join_count_plain(polys, n_edges, mbrs, s, e, active,
                                     ch["count"], ch["x"], ch["y"])

    def point_query(self, parts, bounds, qx, qy, qkf, *, overflow: int,
                    probe: int):
        """(Q,) int32 exact membership: each point's first-match grid
        partition and the overflow grid, the learned lookup in each and
        the equality probe of the window around it, merged."""
        return _pp.point_query_plain(bounds, parts["knot_keys"],
                                     parts["knot_pos"], parts["keys_f"],
                                     parts["x"], parts["y"], parts["count"],
                                     qx, qy, qkf, overflow=overflow,
                                     probe=probe)

    def knn_scan(self, ch, qx, qy, k: int):
        """Per-partition kNN candidates: (neg_d2, vid), (C, Q, k) each,
        nearest first, ties to the lowest position."""
        neg, idx = _knn.knn_topk_plain(qx, qy, ch["count"], ch["x"],
                                       ch["y"], k=k)
        return neg, _map_vid(ch["vid"], neg, idx)

    # -- merge stage helper ----------------------------------------------

    def topk_merge(self, carry_n, carry_v, chunk_n, chunk_v, k: int):
        """Fold a (Q, W) candidate chunk into the running (Q, k) best.
        The carry precedes the chunk and ties go to the lowest index,
        so the streamed result equals one top-k over the whole plane."""
        cn = torch.cat([carry_n, chunk_n], dim=1)
        cv = torch.cat([carry_v, chunk_v], dim=1)
        bn, ix = stable_topk(cn, k)
        return bn, torch.gather(cv, 1, ix)


class CudaBackend(TorchBackend):
    """Lookup and scan stages on the hand-written CUDA kernels."""

    name = "cuda"

    def lower_bound(self, ch, qkf, *, radix_bits: int, probe: int):
        return _ss.spline_search(qkf.contiguous(), *_lookup_args(ch),
                                 probe=probe, radix_bits=radix_bits)

    def range_scan(self, ch, rects, s, e, active=None):
        return _rf.range_count(rects, s, e, _active(active, s), ch["count"],
                               ch["x"], ch["y"])

    def circle_scan(self, ch, rects, s, e, circ, active=None):
        return _cf.circle_count(rects, s, e, circ, _active(active, s),
                                ch["count"], ch["x"], ch["y"])

    def join_scan(self, ch, polys, n_edges, mbrs, s, e, active=None):
        return _pip.join_count(polys, n_edges, mbrs.contiguous(), s, e,
                               _active(active, s), ch["count"], ch["x"],
                               ch["y"])

    def point_query(self, parts, bounds, qx, qy, qkf, *, overflow: int,
                    probe: int):
        return _pp.point_query(bounds.contiguous(), parts["knot_keys"],
                               parts["knot_pos"], parts["keys_f"],
                               parts["x"], parts["y"], parts["count"],
                               qx.contiguous(), qy.contiguous(),
                               qkf.contiguous(), overflow=overflow,
                               probe=probe)

    def knn_scan(self, ch, qx, qy, k: int):
        neg, idx = _knn.knn_topk(qx, qy, ch["count"], ch["x"], ch["y"],
                                 k=k)
        return neg, _map_vid(ch["vid"], neg, idx)


def resolve_backend(name: str, device: torch.device):
    """Backend instance for an EngineConfig.backend string on ``device``.

    "auto" picks the CUDA kernels on a CUDA device and the plain stages
    on the CPU; "cuda" on a CPU device raises."""
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}: expected one of {BACKENDS}")
    if name == "auto":
        name = "cuda" if device.type == "cuda" else "torch"
    if name == "cuda":
        if device.type != "cuda":
            raise ValueError("backend 'cuda' needs a CUDA device, got "
                             f"{device}")
        return CudaBackend()
    return TorchBackend()
