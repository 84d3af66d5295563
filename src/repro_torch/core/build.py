"""Index build (paper §3.1 Alg. 1 + §3.2).

Pipeline (all shapes fixed once the host has sized them):
  1. assign: point -> grid id (first-match containment, the paper's
     per-object loop as a masked min; misses -> overflow id).
  2. shuffle: ONE stable sort by the int64 composite
     (pid << key_bits) | key — Spark's re-partition + per-partition sort.
  3. layout: scatter into dense (P, n_pad) padded rows (sentinel keys).
  4. learn: per-partition greedy spline + radix table (the
     mapPartitions step), on the host in numpy (core/spline.py).

Steps 1-3 run on the index's device; step 4 copies the key plane to the
host and the fitted model back.

The index also carries the mutable state of DESIGN.md §11: per-partition
delta buffers for inserts and tombstone bookkeeping for deletes, which
``core/mutate.py`` fills and compacts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._num import flush_denormals, resolve_device
from repro_torch.core import keys as K
from repro_torch.core import radix as R
from repro_torch.core import spline as S
from repro_torch.core.partitioner import Partitioner

PAD_COORD = 3.0e38

# leaves of the index, in the reference's order
LEAVES = ("key", "x", "y", "vid", "count", "knot_keys", "knot_pos",
          "n_knots", "radix_table", "radix_kmin", "radix_scale",
          "part_bounds", "delta_key", "delta_x", "delta_y", "delta_vid",
          "delta_count", "dead", "max_run", "refit_gen")
# the optional ones: an index built elsewhere may lack them
OPTIONAL_LEAVES = ("delta_key", "delta_x", "delta_y", "delta_vid",
                   "delta_count", "dead", "max_run", "refit_gen")


@dataclasses.dataclass
class LearnedSpatialIndex:
    """Per-partition learned index tensors + static metadata.

    The state splits into the GEOMETRY (the sorted data plane and the
    learned model, rebuilt only by ``build_index`` and
    ``mutate.refit_partitions``) and a per-partition DELTA BUFFER that
    absorbs batched inserts and deletes between re-fits (DESIGN.md §11):

      - a delete keeps the sorted ``key`` row (the spline stays valid)
        and tombstones the slot: coordinates ``PAD_COORD``, vid -1, so
        every coordinate-refine scan, plain or kernel, excludes it;
      - an insert appends to its partition's delta slots, which every
        query probes beside the learned window;
      - ``mutate.refit_partitions`` merges the delta, drops tombstones
        and re-fits the touched partitions only.

    ``epoch`` counts applied mutations; ``shape_epoch`` bumps where a
    static shape changes (delta capacity, n_pad, knot width, probe).
    """

    # --- data plane: (P, n_pad), sorted by key within row ---
    key: torch.Tensor          # int64, sentinel-padded
    x: torch.Tensor            # f32
    y: torch.Tensor            # f32
    vid: torch.Tensor          # int32 original point id, -1 pad
    count: torch.Tensor        # (P,) int32 valid points per partition
    # --- learned model: (P, m) / (P, 2^b+2) ---
    knot_keys: torch.Tensor    # f32
    knot_pos: torch.Tensor     # f32
    n_knots: torch.Tensor      # (P,) int32
    radix_table: torch.Tensor  # int32
    radix_kmin: torch.Tensor   # (P,) f32
    radix_scale: torch.Tensor  # (P,) f32
    # --- global index: (P, 4) partition boxes ---
    part_bounds: torch.Tensor  # f32
    # --- mutable state: delta buffer + tombstone/refit bookkeeping ---
    delta_key: Optional[torch.Tensor] = None    # (P, d_cap) int64
    delta_x: Optional[torch.Tensor] = None      # (P, d_cap) f32
    delta_y: Optional[torch.Tensor] = None      # (P, d_cap) f32
    delta_vid: Optional[torch.Tensor] = None    # (P, d_cap) int32, -1 dead
    delta_count: Optional[torch.Tensor] = None  # (P,) int32 used slots
    dead: Optional[torch.Tensor] = None         # (P,) int32 tombstoned rows
    max_run: Optional[torch.Tensor] = None      # (P,) int32 longest dup run
    refit_gen: Optional[torch.Tensor] = None    # (P,) int32 refit counter
    # --- static ---
    eps: int = 32
    radix_bits: int = 10
    probe: int = 64
    key_spec: K.KeySpec = dataclasses.field(default_factory=K.KeySpec)
    epoch: int = 0
    shape_epoch: int = 0
    overflow_pid: int = -1
    # a meshed executor's shard: its partition rows are the global ones
    # [part_offset, part_offset + num_partitions) of part_total; the
    # boxes, the overflow id and every static stay global
    part_offset: int = 0
    part_total: int = 0

    @property
    def num_partitions(self) -> int:
        """Partition rows held (a shard's own, on a meshed executor)."""
        return self.key.shape[0]

    @property
    def global_partitions(self) -> int:
        """Partitions of the whole index (``num_partitions`` unless
        this is a shard)."""
        return self.part_total or self.num_partitions

    @property
    def n_pad(self) -> int:
        return self.key.shape[1]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @property
    def delta_cap(self) -> int:
        """Delta-buffer slots per partition (0 = no buffer)."""
        return 0 if self.delta_key is None else self.delta_key.shape[1]

    @property
    def overflow(self) -> int:
        """Partition id of the overflow grid (paper §3.1)."""
        return (self.overflow_pid if self.overflow_pid >= 0
                else self.num_partitions - 1)

    def to(self, device) -> "LearnedSpatialIndex":
        """The same index with every tensor on ``device``."""
        dev = resolve_device(device)
        moved = {f: getattr(self, f).to(dev) for f in LEAVES
                 if getattr(self, f) is not None}
        return dataclasses.replace(self, **moved)

    def size_bytes(self) -> dict:
        """Index-only footprint (the paper's 'lightweight' claim): the
        learned model and the global boxes, as the reference counts it
        (the data plane and the delta buffer are data, not index)."""
        model = sum(getattr(self, f).numel() * 4 for f in
                    ("knot_keys", "knot_pos", "radix_table", "n_knots",
                     "radix_kmin", "radix_scale"))
        return {"local_model": int(model),
                "global_index": int(self.part_bounds.numel() * 4)}


def assign_partitions(x, y, boxes, *, chunk: int = 1 << 20):
    """First-match grid id per point; misses -> G (overflow). O(N*G),
    in chunks of ``chunk`` points to bound the (chunk, G) mask. Both
    sides are compared with float32 denormals read as zero, as XLA:CPU
    compares them."""
    g = boxes.shape[0]
    col = torch.arange(g, device=x.device)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    x, y, boxes = (flush_denormals(a) for a in (x, y, boxes))
    xl, yl, xh, yh = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    for i in range(0, x.shape[0], chunk):
        xs = x[i:i + chunk, None]
        ys = y[i:i + chunk, None]
        inside = (xs >= xl) & (xs <= xh) & (ys >= yl) & (ys <= yh)
        out[i:i + chunk] = torch.where(inside, col, g).amin(1)
    return out


def probe_for(eps: int, max_run: int, n_pad: int) -> int:
    """Probe-window width for exact lower bounds: twice (eps + max_run)
    plus headroom, rounded up to a power of two, at most n_pad."""
    probe = int(2 ** np.ceil(np.log2(2 * (eps + max_run) + 4)))
    return min(probe, n_pad)


def fit_partitions(key_g: np.ndarray, counts: np.ndarray, *, eps: int,
                   m_pad: int, radix_bits: int) -> dict:
    """Per-partition spline + radix build (host, numpy)."""
    n_pad = key_g.shape[1]
    valid = np.arange(n_pad)[None, :] < counts[:, None]
    keys_f = np.where(valid, key_g.astype(np.float32), np.float32(3.0e38))
    sp = S.build_spline(keys_f, valid, eps=eps, m_pad=m_pad)
    rx = R.build_radix(sp["knot_keys"], sp["n_knots"], bits=radix_bits)
    return {
        "knot_keys": sp["knot_keys"], "knot_pos": sp["knot_pos"],
        "n_knots": sp["n_knots"], "max_run": sp["max_run"],
        "overflow": sp["overflow"], "radix_table": rx["table"],
        "radix_kmin": rx["kmin"], "radix_scale": rx["scale"],
    }


def build_index(x, y, partitioner: Partitioner, *,
                key_spec: Optional[K.KeySpec] = None, eps: int = 32,
                radix_bits: int = 10, m_pad: Optional[int] = None,
                n_pad: Optional[int] = None, vid=None, delta_cap: int = 0,
                device="cuda") -> LearnedSpatialIndex:
    """Build the learned index of points (x, y) on ``device``.

    Host-level sizing (n_pad / m_pad / probe window) is data-dependent
    and becomes static in the returned index. ``vid`` optionally
    overrides the per-point ids (default: position in the input): with
    it a fresh build of a mutated index's surviving points is that
    index's bitwise twin. ``delta_cap`` pre-allocates the per-partition
    insert slots (the executor grows them on demand).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    n = x.shape[0]
    boxes = torch.as_tensor(partitioner.partition_bounds()[:-1],
                            device=dev)
    if key_spec is None:
        key_spec = K.KeySpec(bounds=partitioner.bounds)

    pid = assign_partitions(x, y, boxes)
    key = K.make_keys(x, y, key_spec)

    p_total = partitioner.num_partitions  # G + 1 (overflow)
    kb = key_spec.key_bits
    if p_total > (1 << (32 - kb)):
        # the reference's composite is uint32; keep its limit
        raise ValueError("too many partitions for uint32 composite key")

    order = torch.sort((pid << kb) | key, stable=True).indices
    key_s, x_s, y_s, pid_s = key[order], x[order], y[order], pid[order]
    if vid is None:
        vid_s = order.to(torch.int32)
    else:
        vid_s = torch.as_tensor(np.asarray(vid, np.int32), device=dev)[order]

    counts = torch.bincount(pid, minlength=p_total)
    if n_pad is None:
        n_pad = int(np.ceil(max(int(counts.max()), 1) / 128) * 128)
    if m_pad is None:
        m_pad = n_pad  # safe upper bound; compacted below

    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(n, device=dev) - starts[pid_s]

    def plane(fill, dtype, values):
        g = torch.full((p_total, n_pad), fill, dtype=dtype, device=dev)
        g[pid_s, col] = values
        return g

    key_g = plane(key_spec.sentinel, torch.int64, key_s)
    x_g = plane(PAD_COORD, torch.float32, x_s)
    y_g = plane(PAD_COORD, torch.float32, y_s)
    vid_g = plane(-1, torch.int32, vid_s)

    counts_np = counts.cpu().numpy().astype(np.int32)
    fit = fit_partitions(key_g.cpu().numpy(), counts_np, eps=eps,
                         m_pad=m_pad, radix_bits=radix_bits)
    if fit["overflow"].any():
        raise RuntimeError("spline knot capacity exceeded; raise m_pad")

    # compact knot arrays to the observed maximum
    m_eff = int(np.ceil(max(int(fit["n_knots"].max()), 2) / 128) * 128)
    m_eff = min(m_eff, m_pad)
    probe = probe_for(eps, int(fit["max_run"].max()), n_pad)

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def zeros(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return LearnedSpatialIndex(
        key=key_g, x=x_g, y=y_g, vid=vid_g,
        count=counts.to(torch.int32),
        knot_keys=dev_t(fit["knot_keys"][:, :m_eff]),
        knot_pos=dev_t(fit["knot_pos"][:, :m_eff]),
        n_knots=dev_t(fit["n_knots"]),
        radix_table=dev_t(fit["radix_table"]),
        radix_kmin=dev_t(fit["radix_kmin"]),
        radix_scale=dev_t(fit["radix_scale"]),
        part_bounds=dev_t(partitioner.partition_bounds()),
        delta_key=zeros((p_total, delta_cap), key_spec.sentinel,
                        torch.int64),
        delta_x=zeros((p_total, delta_cap), PAD_COORD, torch.float32),
        delta_y=zeros((p_total, delta_cap), PAD_COORD, torch.float32),
        delta_vid=zeros((p_total, delta_cap), -1, torch.int32),
        delta_count=zeros((p_total,), 0, torch.int32),
        dead=zeros((p_total,), 0, torch.int32),
        max_run=dev_t(fit["max_run"]),
        refit_gen=zeros((p_total,), 0, torch.int32),
        eps=eps, radix_bits=radix_bits, probe=probe, key_spec=key_spec,
        overflow_pid=p_total - 1,
    )
