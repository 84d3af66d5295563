"""Numerical helpers that pin the port to the JAX reference bit for bit.

* ``fma_f32`` — XLA:CPU contracts ``a*b + c`` into one fused multiply-add
  (distance tests, spline interpolation). Eager PyTorch does not, so the
  plain versions emulate the FMA: the float32 product is exact in
  float64, the float64 sum is rounded to odd (so the final rounding to
  float32 is the single correct rounding), then narrowed. The CUDA
  kernels call ``__fmaf_rn`` for the same value.
* ``flush_denormals`` and the float32 ops ``sub_f32``, ``add_f32``,
  ``mul_f32``, ``div_f32`` (and ``fma_f32``) — XLA:CPU runs with
  denormals-are-zero and flush-to-zero: it reads every float32 denormal
  input of an arithmetic op or a compare as zero (``1e-45 == 0.0``), and
  writes zero for every result whose value, rounded to 24 bits with an
  unbounded exponent, lies below 2^-126 (tininess after rounding). Eager
  PyTorch keeps denormals. So every compared or computed coordinate is
  flushed: loaded values with ``flush_denormals``, results by the ops
  below, which take inputs already flushed. The CUDA kernels do the same
  with ``daz`` and ``ftz`` (``kernels/csrc/common.cuh``).
* ``sqrt_f32`` — a correctly rounded float32 square root, as XLA:CPU
  and CUDA compute it; torch's vectorized CPU kernel is not (an ulp off
  for 0.66 % of inputs, measured on torch 2.13).
* ``stable_topk`` — ``lax.top_k`` breaks value ties by lowest index;
  ``torch.topk`` gives no such order, so a stable descending sort is used.
* ``resolve_device`` — entry points run on the card unless the caller
  asks for the CPU; asking for ``cuda`` without a card raises.
"""
from __future__ import annotations

import numpy as np
import torch

LEAST_NORMAL = float(np.finfo(np.float32).tiny)     # 2^-126
# an exact value below this (2^-126 - 2^-151, exact in float64) rounds,
# to 24 bits with an unbounded exponent, below 2^-126: XLA:CPU writes 0
_TINY_EXACT = LEAST_NORMAL * (1 - 2.0 ** -25)


def flush_denormals(v: torch.Tensor) -> torch.Tensor:
    """``v`` with float32 denormals set to zero (of their sign), as
    XLA:CPU reads them."""
    return v * (v.abs() >= LEAST_NORMAL)


def _ftz(r: torch.Tensor, r4: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's flush of the rounded result ``r`` of an op: zero (of
    its sign) where the exact result, rounded to 24 bits with an
    unbounded exponent, is below 2^-126. ``r4`` is the same op with its
    first input times 4: it lies in the normal range wherever that
    rounding decides, so it is rounded to 24 bits there. ``r`` itself
    differs from the rule only on [2^-126 - 2^-150, 2^-126 - 2^-151),
    where the denormal grid rounds it up to 2^-126. A NaN ``r4`` (an
    overflowing ``4a`` times 0 or over infinity) comes with a zero
    ``r``."""
    return r * (r4.abs() >= 4 * LEAST_NORMAL)


def sub_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` as XLA:CPU computes it; a and b already flushed. A
    difference below 2^-125 is exact (both are multiples of 2^-149), so
    flushing the rounded result is the after-rounding rule."""
    return flush_denormals(a - b)


def add_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as XLA:CPU computes it; a and b already flushed."""
    return flush_denormals(a + b)


def mul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` as XLA:CPU computes it; a and b already flushed."""
    return _ftz(a * b, (a * 4.0) * b)


def div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` as XLA:CPU computes it; a and b already flushed (both
    tensors: torch's reflected ``scalar / tensor`` is not a division)."""
    return _ftz(a / b, (a * 4.0) / b)


def _fma64(a, b, c) -> torch.Tensor:
    """``a*b + c`` of float32 values in float64, rounded to odd: the
    narrowing to float32 is then the single correct rounding, and the
    sum is below ``_TINY_EXACT`` (an even float64) exactly when the
    exact value is."""
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
    # toward the true value
    return torch.where(inexact & even, torch.nextafter(s, toward), s)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` (one rounding, like a
    hardware FMA), flushed as XLA:CPU flushes it; a, b and c already
    flushed. Inputs broadcast; the result is float32."""
    s = _fma64(a, b, c)
    return s.to(torch.float32) * (s.abs() >= _TINY_EXACT)


def dist2_f32(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dx*dx + dy*dy`` as XLA:CPU computes it inside a compiled program:
    contracted to ``fma(dx, dx, dy*dy)`` (tests/test_torch_hazards.py),
    ``dy*dy`` and the sum flushed.

    dx and dy may be differences of unflushed coordinates: a difference
    differs from XLA:CPU's (of the flushed coordinates) only where both
    are below 2^-101, and a square below 2^-202 moves neither the flushed
    ``dy*dy`` nor the FMA's rounding (tests/test_torch_denormals.py).

    A square, and ``fma(dx, dx, yy)`` with ``yy`` 0 or at least 2^-126,
    lies below 2^-126 after the rule's rounding exactly when it does
    after the denormal grid's, so each flush reads its own result."""
    yy = dy * dy
    yy = yy * (yy >= LEAST_NORMAL)
    d2 = _fma64(dx, dx, yy).to(torch.float32)
    return d2 * (d2 >= LEAST_NORMAL)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor: on the CPU
    through float64 (one rounding to float32 of a float64 root is the
    correct one: 53 >= 2 * 24 + 2 bits); CUDA's float32 ``sqrt`` is IEEE
    already."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


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
