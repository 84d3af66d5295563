"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when all lie on one CUDA device; raises on
    anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")


def ptr(t: torch.Tensor, name: str, dtype: torch.dtype,
        shape: tuple) -> ctypes.c_void_p:
    """Device pointer of ``t`` after checking dtype, shape and layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the launchers take it."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
