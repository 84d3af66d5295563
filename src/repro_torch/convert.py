"""Carry an index built elsewhere (e.g. by the JAX package) into the port.

``index_from_arrays`` takes the index's leaves as numpy arrays, so a
caller can run both packages' query paths on the identical index,
whatever either build does, and a mutated index (delta buffers,
tombstones, both epochs) keeps computing what it computed there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._num import resolve_device
from repro_torch.core import keys as K
from repro_torch.core.build import (LEAVES, OPTIONAL_LEAVES,
                                    LearnedSpatialIndex)


def index_from_arrays(leaves: dict, *, device="cuda", key_spec=None,
                      **static) -> LearnedSpatialIndex:
    """Build a ``LearnedSpatialIndex`` from numpy leaves.

    ``leaves`` maps the names in ``core.build.LEAVES`` to arrays (keys
    and delta keys may be uint32; they are held as int64). The names in
    ``OPTIONAL_LEAVES`` may be missing or None (an index with no delta
    buffer). ``key_spec`` is any object with ``kind``, ``bits_per_dim``
    and ``bounds``; ``static`` holds eps, radix_bits, probe,
    overflow_pid, epoch and shape_epoch.
    """
    dev = resolve_device(device)
    missing = [n for n in LEAVES if n not in OPTIONAL_LEAVES
               and n not in leaves]
    if missing:
        raise KeyError(f"missing index leaves: {missing}")
    tensors = {}
    for name in LEAVES:
        if leaves.get(name) is None:
            continue
        a = np.array(leaves[name])      # a writable copy
        if a.dtype == object:           # np.asarray(None): an absent leaf
            continue
        if name in ("key", "delta_key"):
            a = a.astype(np.int64)
        tensors[name] = torch.as_tensor(a, device=dev)
    if key_spec is not None:
        key_spec = K.KeySpec(kind=key_spec.kind,
                             bits_per_dim=int(key_spec.bits_per_dim),
                             bounds=tuple(float(b) for b in key_spec.bounds))
        static["key_spec"] = key_spec
    return LearnedSpatialIndex(**tensors, **static)
