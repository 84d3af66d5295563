"""Carry an index, or a model's parameters, built elsewhere (e.g. by the
JAX package) into the port.

``index_from_arrays`` takes the index's leaves as numpy arrays, so a
caller can run both packages' query paths on the identical index,
whatever either build does, and a mutated index (delta buffers,
tombstones, both epochs) keeps computing what it computed there.
``index_to_arrays`` is its inverse: the leaves and the statics of an
index, which ``checkpoint.save_checkpoint`` persists (the statics as
its ``meta``) for a restart to restore:

    arrays, statics = index_to_arrays(index)
    save_checkpoint(d, 1, arrays, meta=statics)
    # later, in any process:
    back = load_index(d, 1, device=dev)
    # or, on each rank of a mesh, only that rank's shard:
    shard = load_index(d, 1, device=dev, mesh=mesh, config=cfg)
    ex = Executor(shard, cfg, dev, mesh=mesh)

``params_from_arrays`` takes an LM's parameter tree (the JAX package's
``model.init(...)``: nested dicts of arrays) as tensors with the same
paths, shapes and dtypes; ``params_to_arrays`` gives it back as numpy.
``opt_state_from_arrays`` and ``opt_state_to_arrays`` do the same for
an optimizer state (``step`` and the ``m`` and ``v`` trees, e.g. the
JAX package's ``adamw_init``/``adamw_update`` output).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._num import resolve_device
from repro_torch.checkpoint import (latest_step, load_checkpoint, read_meta,
                                    rows_of)
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core.build import (LEAVES, OPTIONAL_LEAVES,
                                    LearnedSpatialIndex)
from repro_torch.core.plan import EngineConfig
from repro_torch.train.optimizer import AdamWState


def index_from_arrays(leaves: dict, *, device="cuda", key_spec=None,
                      **static) -> LearnedSpatialIndex:
    """Build a ``LearnedSpatialIndex`` from its leaves.

    ``leaves`` maps the names in ``core.build.LEAVES`` to numpy arrays
    or tensors (keys and delta keys may be uint32; they are held as
    int64; a tensor is moved to ``device``, not copied). The names in
    ``OPTIONAL_LEAVES`` may be missing or None (an index with no delta
    buffer). ``key_spec`` is any object with ``kind``, ``bits_per_dim``
    and ``bounds``, or a dict of them (``index_to_arrays``' statics);
    ``static`` holds eps, radix_bits, probe, overflow_pid, epoch and
    shape_epoch (and may hold ``index_to_arrays``' ``leaf_specs``, unused).
    """
    dev = resolve_device(device)
    static.pop("leaf_specs", None)
    missing = [n for n in LEAVES if n not in OPTIONAL_LEAVES
               and n not in leaves]
    if missing:
        raise KeyError(f"missing index leaves: {missing}")
    tensors = {}
    for name in LEAVES:
        v = leaves.get(name)
        wide = torch.int64 if name in ("key", "delta_key") else None
        if isinstance(v, torch.Tensor):     # e.g. from load_checkpoint
            tensors[name] = v.to(dev, wide or v.dtype)
            continue
        if v is None:
            continue
        a = np.array(v)                 # a writable copy
        if a.dtype == object:           # np.asarray(None): an absent leaf
            continue
        if wide is not None:
            a = a.astype(np.int64)
        tensors[name] = torch.as_tensor(a, device=dev)
    if key_spec is not None:
        get = (key_spec.__getitem__ if isinstance(key_spec, dict)
               else lambda a: getattr(key_spec, a))
        static["key_spec"] = K.KeySpec(
            kind=get("kind"), bits_per_dim=int(get("bits_per_dim")),
            bounds=tuple(float(b) for b in get("bounds")))
    return LearnedSpatialIndex(**tensors, **static)


STATICS = ("eps", "radix_bits", "probe", "overflow_pid", "epoch",
           "shape_epoch")


def index_to_arrays(index: LearnedSpatialIndex) -> tuple:
    """(leaves, statics) of ``index``: every leaf of ``core.build.LEAVES``
    the index holds as a numpy array (the optional ones that are None
    left out; keys stay int64), and its statics as JSON-able values,
    ``key_spec`` as a dict, ``leaf_specs`` each leaf's shape and dtype (for
    ``leaves_like``). ``index_from_arrays(leaves, **statics)`` is the
    same index."""
    leaves = {name: getattr(index, name).detach().cpu().numpy()
              for name in LEAVES if getattr(index, name) is not None}
    spec = index.key_spec
    statics = {name: int(getattr(index, name)) for name in STATICS}
    statics["key_spec"] = {"kind": spec.kind,
                           "bits_per_dim": int(spec.bits_per_dim),
                           "bounds": [float(b) for b in spec.bounds]}
    statics["leaf_specs"] = {
        name: {"shape": list(a.shape), "dtype": a.dtype.str}
        for name, a in leaves.items()}
    return leaves, statics


def leaves_like(statics: dict) -> dict:
    """``meta`` tensors of the leaves ``index_to_arrays`` described in
    ``statics``: the prototype ``checkpoint.load_checkpoint`` restores
    an index into, with nothing allocated."""
    return {name: torch.empty(spec["shape"], device="meta",
                              dtype=torch.from_numpy(
                                  np.empty(0, spec["dtype"])).dtype)
            for name, spec in statics["leaf_specs"].items()}


def load_index(ckpt_dir: str, step: Optional[int] = None, *, device="cuda",
               mesh=None, part_axis="data",
               config: Optional[EngineConfig] = None) -> LearnedSpatialIndex:
    """The index that ``save_checkpoint(ckpt_dir, step, *index_to_arrays(
    index))`` wrote (``step`` None: the newest), on ``device``.

    With ``mesh``, only this rank's shard goes to the device: the
    partition rows that ``Executor(index, config, device, mesh=mesh,
    part_axis=part_axis)`` keeps of the whole index, padded as it pads
    (``local_ops.pad_shard``), cut on the host by ``checkpoint.rows_of``.
    Pass it to that executor, which takes it as it is."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    meta = read_meta(ckpt_dir, step)
    proto = leaves_like(meta)
    if mesh is None:
        return index_from_arrays(
            load_checkpoint(ckpt_dir, step, proto, device=dev), device=dev,
            **meta)
    axis = mesh.axis(part_axis)
    p = proto["key"].shape[0]
    chunk = (config if config is not None else EngineConfig()).part_chunk
    p_total = L.padded_count(p, axis.size * chunk)
    p_loc = p_total // axis.size
    off = axis.offset(p_loc)
    rows = load_checkpoint(ckpt_dir, step, proto, device=dev,
                           place=rows_of(off, p_loc, skip=("part_bounds",)))
    # the overflow grid's global id: the last partition by default
    over = meta["overflow_pid"] if meta["overflow_pid"] >= 0 else p - 1
    index = index_from_arrays(rows, device=dev,
                              **dict(meta, overflow_pid=over))
    return L.pad_shard(index, off, p_loc, p_total)


def _tensor(a, dev) -> torch.Tensor:
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: its bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_arrays(tree, *, device="cuda"):
    """A model's parameters (or cache, or state) from a nested dict of
    arrays, e.g. the JAX package's ``model.init(...)`` tree: the same
    paths and shapes, each leaf a tensor of the same dtype on
    ``device`` (bfloat16 leaves keep their bits)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_arrays(v, device=dev)
                for k, v in tree.items()}
    return _tensor(tree, dev)


def params_to_arrays(params):
    """The inverse of ``params_from_arrays``: a nested dict of numpy
    arrays on the host with the same paths and shapes. numpy has no
    bfloat16, so such a leaf comes back as float32 (exactly)."""
    if isinstance(params, dict):
        return {k: params_to_arrays(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def opt_state_from_arrays(state, *, device="cuda") -> AdamWState:
    """An ``AdamWState`` from an optimizer state built elsewhere: an
    object with ``step``, ``m`` and ``v`` (the JAX package's
    ``AdamWState``) or a dict of them (``opt_state_to_arrays``'), each
    leaf a tensor of its dtype on ``device``."""
    get = state.get if isinstance(state, dict) else \
        lambda k: getattr(state, k)
    return AdamWState(step=params_from_arrays(get("step"), device=device),
                      m=params_from_arrays(get("m"), device=device),
                      v=params_from_arrays(get("v"), device=device))


def opt_state_to_arrays(state: AdamWState) -> dict:
    """The inverse of ``opt_state_from_arrays``: {"step", "m", "v"} as
    numpy on the host."""
    return {"step": params_to_arrays(state.step),
            "m": params_to_arrays(state.m), "v": params_to_arrays(state.v)}
