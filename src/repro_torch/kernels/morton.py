"""Morton (Z-order) bit interleave: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/morton.py``
(``morton_encode_2d``; wrapper ``kernels/ops.py:morton_encode``).
Source: ``csrc/morton.cu``, an elementwise grid-stride pass with 16-byte
loads and stores. Bound: bytes (24 per point, int64 in and out).

The port holds keys in int64 (``core/keys.py``): the wrapper takes int64
tensors holding uint32 values and returns int64 keys, the reference's
uint32 keys zero-extended. Only the low 32 bits of each input count, as
the reference's ``astype(uint32)`` keeps them, and the key is masked to
32 bits where the reference's uint32 shifts wrap.

As in the reference, the index build does not call this kernel: its key
step is ``core/keys.morton_encode``, plain int64 PyTorch. This is the
kernel at its own entry point. Its inputs are integers, so XLA:CPU's
float32 denormal flush (``_num``) has nothing to act on here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launches
from repro_torch.kernels._args import P, on_cpu, ptr, stream

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"morton_encode_launch": [P, P, P, ctypes.c_int64, P]}
_U32 = 0xFFFFFFFF


def _spread(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of ``v`` to the even bit positions (uint32 math:
    the masks drop every bit a uint32 shift would lose)."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_encode_plain(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """(N,) int64 morton keys of (N,) int64 quantized coordinates: x on
    the even bits, y on the odd ones, in uint32 arithmetic."""
    return (_spread(qx & _U32) | (_spread(qy & _U32) << 1)) & _U32


def morton_encode(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """(N,) int64 morton keys of (N,) int64 quantized coordinates (uint32
    values). CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    if on_cpu(qx, qy):
        return morton_encode_plain(qx, qy)
    n = qx.shape[0]
    i64 = torch.int64
    ptrs = [ptr(qx, "qx", i64, (n,)), ptr(qy, "qy", i64, (n,))]
    out = torch.empty(n, dtype=i64, device=qx.device)
    if n == 0:
        return out
    for t, name in ((qx, "qx"), (qy, "qy")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    from repro_torch.kernels import _build
    lib = _build.load("morton", _SIG)
    err = lib.morton_encode_launch(*ptrs, ptr(out, "out", i64, (n,)), n,
                                   stream())
    _build.check(lib, "morton", err)
    _launches.count(__name__)
    return out
