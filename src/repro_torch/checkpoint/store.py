"""Step-atomic checkpoints of trees of tensors, with auto-resume.

The counterpart of the reference's ``src/repro/checkpoint/store.py``,
on the same layout, so a checkpoint written by either package loads in
the other:

    <dir>/step_00001234/
        arrays.npz          flat {path -> np.ndarray}
        manifest.json       step, keys, user meta

A tree is nested dicts, lists, tuples and dataclasses whose leaves are
tensors (on any device), numpy arrays or Python numbers; a None is no
leaf. A leaf's path joins its dict keys, sequence indices and
``.field`` names with ``/``, dict keys sorted and fields in declaration
order, as the reference's ``tree_flatten_with_path`` names them (a
registered dataclass's ``GetAttrKey`` prints as ``.field``: an
``AdamWState`` saves as ``opt/.step``, ``opt/.m/<path>``,
``opt/.v/<path>``). A
checkpoint is written to ``step_X.tmp-<pid>`` and renamed into place
(an older ``step_X`` is moved to ``.old`` first and removed after), so
a crash mid-write never corrupts the newest valid one.

Loading casts each array to its prototype's dtype by value: the port
holds keys in int64 where the reference holds uint32. Arrays stay
unsharded on disk; ``place`` cuts each leaf on the host before it goes
to ``device`` (``rows_of``: a meshed rank's partition rows), the
reference's elastic reshard: ``convert.load_index(..., mesh=)`` restores
a rank's shard of an index this way for its meshed ``Executor``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._num import resolve_device


def _paths(tree, prefix=()):
    """(path tuple, leaf) of every leaf of ``tree``, in the reference's
    order (dict keys sorted)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _paths(getattr(tree, f.name), prefix + ("." + f.name,))
    else:
        yield prefix, tree


def _host(v, copy: bool) -> np.ndarray:
    """A leaf on the host; with ``copy`` a copy of its own, which later
    writes to the leaf (in place, as the update path and CUDA graphs
    do) do not reach."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=copy).numpy()
    return np.array(v, copy=True) if copy else np.asarray(v)


def _flatten(tree, copy: bool) -> dict:
    return {"/".join(p): _host(v, copy) for p, v in _paths(tree)}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype, device="cpu").numpy().dtype


def _unflatten_into(tree_like, flat: dict, device, place, prefix=()):
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, device, place,
                                   prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        out = [_unflatten_into(v, flat, device, place, prefix + (str(i),))
               for i, v in enumerate(tree_like)]
        return type(tree_like)(out)
    if dataclasses.is_dataclass(tree_like) and not isinstance(tree_like,
                                                              type):
        return dataclasses.replace(tree_like, **{
            f.name: _unflatten_into(getattr(tree_like, f.name), flat,
                                    device, place, prefix + ("." + f.name,))
            for f in dataclasses.fields(tree_like)})
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(tree_like.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {tuple(tree_like.shape)}")
    t = torch.from_numpy(arr.astype(_np_dtype(tree_like.dtype), order="C",
                                    copy=False))
    if place is None:
        return t.to(device)
    return place(key, t).contiguous().to(device, copy=True)


def save_checkpoint(ckpt_dir: str, step: int, tree, meta: Optional[dict]
                    = None, async_write: bool = False):
    """Atomically persist ``tree`` for ``step``; ``meta`` (JSON-able)
    goes into the manifest. With ``async_write`` every leaf is copied to
    the host before this returns, so the caller may overwrite its
    tensors at once; without, a leaf already on the host is written
    from where it is. Returns the writer thread to join, or None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree, copy=async_write)

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat.keys()),
                    "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            os.rename(final, final + ".old")
        os.rename(tmp, final)
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)

    if async_write:
        t = threading.Thread(target=write, daemon=False)
        t.start()
        return t
    write()
    return None


def _valid_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or ".tmp" in name or \
                name.endswith(".old"):
            continue
        man = os.path.join(ckpt_dir, name, "manifest.json")
        arr = os.path.join(ckpt_dir, name, "arrays.npz")
        if os.path.exists(man) and os.path.exists(arr):
            try:
                with open(man) as f:
                    steps.append(int(json.load(f)["step"]))
            except Exception:
                continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose manifest and arrays are both in place."""
    steps = _valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_meta(ckpt_dir: str, step: int) -> dict:
    """The ``meta`` a checkpoint was saved with."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["meta"]


def load_checkpoint(ckpt_dir: str, step: int, tree_like, device="cuda",
                    place: Optional[Callable] = None):
    """Load into the structure of ``tree_like``, whose leaves (tensors
    on any device, ``meta`` too) give each leaf's shape and dtype; the
    leaves come back on ``device``. ``place(path, leaf)`` may cut a
    leaf on the host first (see ``rows_of``)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(tree_like, flat, dev, place)


def restore_or_init(ckpt_dir: str, init_fn: Callable[[], Any],
                    device="cuda", place: Optional[Callable] = None):
    """Auto-resume: the newest valid checkpoint, else ``init_fn()``.
    The prototype is ``init_fn`` run under ``torch.device("meta")``, so
    nothing is allocated for it. Returns (tree, start_step)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return init_fn(), 0
    with torch.device("meta"):
        proto = init_fn()
    return load_checkpoint(ckpt_dir, step, proto, device, place), step


def rows_of(offset: int, count: int, skip=()) -> Callable:
    """A ``place`` that keeps rows ``[offset, offset + count)`` of every
    leaf with at least one axis, except leaves whose last path part is
    in ``skip``: a meshed rank's partition rows, as
    ``core/local_ops.shard_partitions`` cuts them (skip
    ``part_bounds``, which every rank holds whole)."""
    def place(path: str, leaf):
        if path.split("/")[-1] in skip or leaf.ndim == 0:
            return leaf
        return leaf[offset:offset + count]
    return place
