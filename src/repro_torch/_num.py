"""Numerical helpers that pin the port to the JAX reference bit for bit.

* ``fma_f32`` — XLA:CPU contracts ``a*b + c`` into one fused multiply-add
  (distance tests, spline interpolation). Eager PyTorch does not, so the
  plain versions emulate the FMA: the float32 product is exact in
  float64, the float64 sum is rounded to odd (so the final rounding to
  float32 is the single correct rounding), then narrowed. The CUDA
  kernels call ``__fmaf_rn`` for the same value.
* ``stable_topk`` — ``lax.top_k`` breaks value ties by lowest index;
  ``torch.topk`` gives no such order, so a stable descending sort is used.
* ``resolve_device`` — entry points run on the card unless the caller
  asks for the CPU; asking for ``cuda`` without a card raises.
"""
from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` (one rounding, like a
    hardware FMA). Inputs broadcast; the result is float32."""
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64)
    if isinstance(c, torch.Tensor):
        c64 = c.to(device=a64.device, dtype=torch.float64)
    else:    # a scalar is filled on the device: no host-to-device copy
        c64 = torch.full((), float(c), dtype=torch.float64,
                         device=a64.device)
    p = a64 * b64                        # exact: 24 x 24 bits <= 53 bits
    s = p + c64
    # TwoSum: s + err == p + c exactly (when s is finite)
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    inexact = torch.isfinite(s) & (err != 0)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the true value, so narrowing cannot double-round
    s = torch.where(inexact & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def stable_topk(values: torch.Tensor, k: int):
    """Top-k along the last axis, descending, ties to the lowest index
    (``lax.top_k``'s order). Returns (values, indices int64)."""
    v, ix = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], ix[..., :k]


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    when CUDA is asked for and no card is present (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
