"""Meshes over the ranks of a torch.distributed world.

The counterpart of the reference's ``src/repro/launch/mesh.py``. A jax
``Mesh`` lays devices out on named axes under one controller; here each
rank is a process of its own (SPMD): every rank makes the same calls
with the same arguments, holds its own shard, and meets the others in
the collectives of its process groups. NCCL runs on the card and gloo on
CPU tensors; the backend follows the device, with no switch between the
two.

    from repro_torch.launch import mesh as M
    dev = M.init_process("cuda")              # or "cpu" (gloo)
    mesh = M.make_host_mesh(device=dev)       # (world, 1) ("data", "model")
    eng = SpatialEngine(index, device=dev, mesh=mesh, part_axis="data")

Run under ``python -m torch.distributed.run --nproc_per_node N ...``
(which sets the rank, the world size and the rendezvous address), or
pass ``init_method``, ``world_size`` and ``rank`` (a ``file://`` store
needs no port). The card gives one device per rank, so on one H100 the
world size is 1.

``Mesh.axis(axes)`` gives the group of ranks that differ only in the
coordinates of ``axes`` (row-major, as ``P(axes)`` lays partitions out)
and its collectives. Each collective it issues counts one launch in this
module's ``launches`` through ``kernels/_launches.py``, so a CUDA graph
that captured collectives adds them on each replay.

Not ported: the reference's production meshes (``make_production_mesh``,
16 x 16 and 2 x 16 x 16 chips), which only its dry run builds (ROADMAP
item 18b).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import _launches as KL

launches = 0        # collectives issued (a graph replay adds its own)


def backend_for(device) -> str:
    """The process-group backend of a device: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process(device="cuda", init_method: Optional[str] = None,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None, timeout=None) -> torch.device:
    """Join the process group (once per process) and return this rank's
    device: the card of its local rank, or the CPU.

    Without ``init_method`` the rank, world size and rendezvous come
    from the environment ``torch.distributed.run`` sets. On the card the
    group is NCCL with ``device_id`` set, so its communicator is created
    here, eagerly, and never lazily inside a CUDA graph capture; on the
    CPU it is gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process: no CUDA device; pass "
                               "device='cpu' for gloo")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank or 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend_for(dev):
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}, not "
                               f"{backend_for(dev)} for {dev}")
        return dev
    kw = {}
    if init_method is not None:
        kw.update(init_method=init_method, world_size=int(world_size),
                  rank=int(rank))
    if timeout is not None:
        kw["timeout"] = timeout
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(backend_for(dev), **kw)
    return dev


def _names(axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


class Axis:
    """One mesh axis (or a tuple of them) seen from this rank: the
    process group of the ranks that share this rank's other coordinates,
    its ``size``, this rank's ``index`` in it (row-major over the axes)
    and the collectives the local programs merge with. Every collective
    is issued, also in a group of one: a size is never short-circuited,
    so the card runs NCCL even at world size 1."""

    def __init__(self, group, size: int, index: int, device):
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.device = torch.device(device)

    def offset(self, p_loc: int) -> int:
        """First global partition of this rank's shard of ``p_loc``."""
        return self.index * int(p_loc)

    def _reduce(self, x, op):
        KL.count(__name__)
        y = x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (``lax.psum``)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the group (``lax.pmax``)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def _gather(self, x, dim: int):
        KL.count(__name__)
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return torch.cat(out, dim)

    def all_gather1(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` side by side along dim 1, in group order
        (``lax.all_gather(x, axis, axis=1, tiled=True)``)."""
        return self._gather(x, 1)

    def all_gather0(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows one after the other, in group order (the
        query axis's un-shard)."""
        return self._gather(x, 0)

    def agree(self, values: Sequence[int], op: str = "max") -> list:
        """Host integers made equal on every rank of the group: their
        maximum (``op="max"``) or sum (``"sum"``). The executor agrees
        every shape static of a mutation this way before it installs it,
        so every rank bumps ``shape_epoch`` together."""
        t = torch.as_tensor([int(v) for v in values], dtype=torch.int64,
                            device=self.device)
        red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        return [int(v) for v in self._reduce(t, red).tolist()]


class Mesh:
    """Named axes over the ranks of the world, row-major, wrapping a
    ``DeviceMesh``. ``shape`` maps each axis name to its size. One axis
    takes the DeviceMesh's own group; a tuple of axes a group made with
    ``dist.new_group``, which every rank creates for every such group in
    one fixed order (rows of the rank grid, row-major), as
    ``new_group`` requires. Build meshes and executors on every rank in
    the same order."""

    def __init__(self, device_mesh, device):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in device_mesh.mesh.shape)))
        self._axes = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        c = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        idx = 0
        for a in _names(axes):
            idx = idx * self.shape[a] + int(c[a])
        return idx

    def axis(self, axes) -> Axis:
        """The ``Axis`` of ``axes`` (a name or a tuple of names)."""
        names = _names(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}: "
                                 f"{self.axis_names}")
        if names not in self._axes:
            if len(names) == 1:
                group = self.device_mesh.get_group(names[0])
            else:
                group = self._new_group(names)
            self._axes[names] = Axis(group, math.prod(
                self.shape[a] for a in names), self.coord(names),
                self.device)
        return self._axes[names]

    def _new_group(self, names):
        dims = [self.axis_names.index(a) for a in names]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        grid = self.device_mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(self.shape[a] for a in names))
        me = dist.get_rank()
        mine = None
        for row in grid.tolist():       # every rank, every group, in order
            g = dist.new_group(ranks=row)
            if me in row:
                mine = g
        return mine


def make_host_mesh(shape=None, axes=None, device="cuda") -> Mesh:
    """A mesh over the initialised world (``init_process``): by default
    ``(world, 1)`` as ``("data", "model")``, as the reference's."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: call init_process first")
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if shape is None:
        shape = (dist.get_world_size(), 1)
        axes = ("data", "model")
    axes = tuple(axes or ("data", "model"))
    dm = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                          mesh_dim_names=axes)
    return Mesh(dm, dev)


def world_size() -> int:
    """Ranks in the world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1
