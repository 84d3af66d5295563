"""1-D key derivation for 2-D spatial points (paper §3.2).

``morton`` keys interleave the bits of the quantized coordinates
(Z-order); ``x`` / ``y`` keys use one axis. Keys stay at <= 24 bits so
their float32 image is exact.

Keys are held in int64: torch on the CPU implements neither shifts nor
comparisons nor ``searchsorted`` for uint32, and every key (and the
build's ``(pid << key_bits) | key`` composite) fits in int64 exactly.
Float-to-int casts clamp first, so no value is ever out of range.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

DEFAULT_BITS_PER_DIM = 11          # 22-bit morton keys, exact in float32
MAX_BITS_PER_DIM = 12              # 24-bit morton keys, still exact in f32


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """How 2-D points are projected to 1-D sort keys."""

    kind: str = "morton"           # 'morton' | 'x' | 'y'
    bits_per_dim: int = DEFAULT_BITS_PER_DIM
    # Data-space bounds used for quantization: (xlo, ylo, xhi, yhi).
    bounds: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)

    @property
    def key_bits(self) -> int:
        if self.kind == "morton":
            return 2 * self.bits_per_dim
        return self.bits_per_dim

    @property
    def sentinel(self) -> int:
        """Padding key, strictly greater than every valid key."""
        return 1 << self.key_bits

    def __post_init__(self):
        if self.kind not in ("morton", "x", "y"):
            raise ValueError(f"unknown key kind {self.kind!r}")
        if self.kind == "morton" and self.bits_per_dim > MAX_BITS_PER_DIM:
            raise ValueError(
                "morton keys above 24 total bits are not exact in float32")


def quantize(coord: torch.Tensor, lo: float, hi: float, bits: int):
    """Map float32 coords in [lo, hi] to int64 in [0, 2^bits - 1].

    The reference computes in float32 throughout: ``lo`` and the scale
    are float32 scalars, and the scale is a float32 division."""
    scale = np.float32(1 << bits) / np.float32(max(hi - lo, 1e-30))
    lo32 = torch.tensor(np.float32(lo), device=coord.device)
    q = torch.floor((coord - lo32) *
                    torch.tensor(scale, device=coord.device))
    return torch.clamp(q, 0, (1 << bits) - 1).to(torch.int64)


def spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` to even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_encode(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Interleave quantized coords: x gets even bits, y odd bits."""
    return spread_bits(qx) | (spread_bits(qy) << 1)


def make_keys(x: torch.Tensor, y: torch.Tensor, spec: KeySpec):
    """Project float32 point coords to int64 sort keys per ``spec``."""
    xlo, ylo, xhi, yhi = spec.bounds
    if spec.kind == "morton":
        qx = quantize(x, xlo, xhi, spec.bits_per_dim)
        qy = quantize(y, ylo, yhi, spec.bits_per_dim)
        return morton_encode(qx, qy)
    if spec.kind == "x":
        return quantize(x, xlo, xhi, spec.bits_per_dim)
    return quantize(y, ylo, yhi, spec.bits_per_dim)


def rect_key_range(rect: torch.Tensor, spec: KeySpec):
    """[key_lo, key_hi] covering every point inside rect=(xl,yl,xh,yh).

    Valid because morton codes (and axis keys) are monotone in each
    coordinate."""
    xl, yl, xh, yh = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    return make_keys(xl, yl, spec), make_keys(xh, yh, spec)


def keys_to_f32(keys: torch.Tensor) -> torch.Tensor:
    """Exact float32 image of (<= 24 bit) integer keys."""
    return keys.to(torch.float32)
