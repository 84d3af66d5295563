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
So is the delta stage (``delta_live``, ``delta_scan``,
``delta_join_scan``, ``delta_knn_scan``: the live delta-buffer probes of
DESIGN.md §11): the buffers hold at most ``d_cap`` points per
partition, so a full masked scan is the whole plan, no Pallas kernel
computes it in the reference (its PallasBackend inherits the XLA
stages), and CudaBackend inherits TorchBackend's.

``resolve_backend("auto", device)`` picks cuda on a CUDA device and torch
on the CPU. ``torch`` on a CUDA device is allowed: it is how a kernel is
held against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch._num import dist2_f32, flush_denormals, mul_f32, stable_topk
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
                    probe: int, part_offset: int = 0):
        """(Q,) int32 exact membership: each point's first-match grid
        partition and the overflow grid, the learned lookup in each and
        the equality probe of the window around it, merged; a candidate
        outside the planes' partitions [part_offset, part_offset + P_loc)
        counts 0."""
        return _pp.point_query_plain(bounds, parts["knot_keys"],
                                     parts["knot_pos"], parts["keys_f"],
                                     parts["x"], parts["y"], parts["count"],
                                     qx, qy, qkf, overflow=overflow,
                                     probe=probe, part_offset=part_offset)

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

    # -- delta stage (plain PyTorch on both backends) ----------------------

    def delta_live(self, ch):
        """(C, d_cap) live-slot mask of a chunk's delta buffers (the
        per-row form of ``queries.gather_delta``'s rule: change both
        together)."""
        slot = torch.arange(ch["dvid"].shape[1], dtype=torch.int32,
                            device=ch["dvid"].device)
        return (slot < ch["dcount"][:, None]) & (ch["dvid"] >= 0)

    def _delta_in_rect(self, ch, rects, active):
        """(C, Q, d_cap) live buffered points inside each rect (compares
        with denormals read as zero), for active (C, Q) pairs."""
        fx = flush_denormals(ch["dx"])[:, None, :]
        fy = flush_denormals(ch["dy"])[:, None, :]
        r = flush_denormals(rects)[None, :, :, None]         # (1, Q, 4, 1)
        m = (self.delta_live(ch)[:, None, :] &
             (fx >= r[..., 0, :]) & (fx <= r[..., 2, :]) &
             (fy >= r[..., 1, :]) & (fy <= r[..., 3, :]))
        if active is not None:
            m = m & active[..., None]
        return m

    def delta_scan(self, ch, rects, circ=None, active=None):
        """(C, Q) int32 live buffered points in each rect (and circle:
        ``fma(dx, dx, dy*dy) <= r*r``, flushed, as the circle scan)."""
        m = self._delta_in_rect(ch, rects, active)
        if circ is not None:
            # the differences are only squared: no flush needed
            dx = ch["dx"][:, None, :] - circ[None, :, 0, None]
            dy = ch["dy"][:, None, :] - circ[None, :, 1, None]
            r = circ[None, :, 2, None]
            m = m & (dist2_f32(dx, dy) <= mul_f32(r, r))
        return m.sum(-1, dtype=torch.int32)

    def delta_join_scan(self, ch, polys, n_edges, mbrs, active=None):
        """(C, PG) int32 live buffered points inside each polygon's MBR
        and the polygon (ray casting)."""
        m = self._delta_in_rect(ch, mbrs, active)              # (C, PG, d)
        c, d_cap = ch["dx"].shape
        pg = polys.shape[0]
        inside = _pip.point_in_polygon_plain(
            ch["dx"].reshape(1, -1).expand(pg, -1),
            ch["dy"].reshape(1, -1).expand(pg, -1), polys, n_edges)
        inside = inside.reshape(pg, c, d_cap).transpose(0, 1)
        return (m & inside).sum(-1, dtype=torch.int32)

    def delta_knn_scan(self, ch, qx, qy):
        """Buffered kNN candidates: (neg_d2, vid), (C, Q, d_cap) each, in
        slot order; dead and empty slots hold (-3e38, -1). The program
        merges them after the chunk's main-plane candidates."""
        live = self.delta_live(ch)[:, None, :]
        dx = ch["dx"][:, None, :] - qx[None, :, None]
        dy = ch["dy"][:, None, :] - qy[None, :, None]
        neg = torch.where(live, -dist2_f32(dx, dy), _knn.NEG)
        vid = torch.where(live, ch["dvid"][:, None, :], -1)
        return neg, vid.expand(neg.shape)


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
                    probe: int, part_offset: int = 0):
        return _pp.point_query(bounds.contiguous(), parts["knot_keys"],
                               parts["knot_pos"], parts["keys_f"],
                               parts["x"], parts["y"], parts["count"],
                               qx.contiguous(), qy.contiguous(),
                               qkf.contiguous(), overflow=overflow,
                               probe=probe, part_offset=part_offset)

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
