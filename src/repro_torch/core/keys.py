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
    are float32 scalars, and the scale is a float32 division. Both are
    filled on the device (no host-to-device copy on the query path)."""
    scale = np.float32(1 << bits) / np.float32(max(hi - lo, 1e-30))
    dev = coord.device
    lo32 = torch.full((), float(np.float32(lo)), dtype=torch.float32,
                      device=dev)
    q = torch.floor((coord - lo32) * torch.full(
        (), float(scale), dtype=torch.float32, device=dev))
    return torch.clamp(q, 0, (1 << bits) - 1).to(torch.int64)


def spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` to even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`spread_bits` (decoding)."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def morton_encode(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Interleave quantized coords: x gets even bits, y odd bits."""
    return spread_bits(qx) | (spread_bits(qy) << 1)


def morton_decode(key: torch.Tensor):
    return compact_bits(key), compact_bits(key >> 1)


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


_U32 = 0xFFFFFFFF


def _msb_position(v: torch.Tensor) -> torch.Tensor:
    """Highest set bit position of a uint32 value (0 -> 0), integer-exact.
    The reference's SWAR popcount multiplies in uint32, which wraps: the
    product is masked to 32 bits before the shift."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    pc = ((v * 0x01010101) & _U32) >> 24
    return torch.clamp(pc - 1, min=0)


def z_split_intervals(qxl, qyl, qxh, qyh, valid, *, depth: int = 2):
    """Decompose a quantized rect's morton interval (BIGMIN-style).

    Splitting the rect at the most significant differing morton bit,
    ``depth`` times, gives up to 2^depth DISJOINT subintervals that still
    cover every in-rect key. Inputs are (...,) int64 quantized corners
    (values of the reference's uint32) and validity. Returns (zlo, zhi,
    piece_valid), each with a new trailing 2^depth axis.

    The reference computes in uint32; ``hbx - 1`` and ``hby - 1`` wrap
    there when hbx or hby is 0 (only in invalid pieces), so both are
    masked to 32 bits here and every later step sees the same value.
    """
    pieces = [(qxl, qyl, qxh, qyh, valid)]
    for _ in range(depth):
        nxt = []
        for (xl, yl, xh, yh, v) in pieces:
            diff = morton_encode(xl, yl) ^ morton_encode(xh, yh)
            msb = _msb_position(diff)
            even = (msb % 2) == 0          # even bits carry x
            b = msb // 2
            hbx = (xh >> b) << b
            hby = (yh >> b) << b
            nosplit = diff == 0
            x1h = torch.where(nosplit, xh,
                              torch.where(even, (hbx - 1) & _U32, xh))
            y1h = torch.where(nosplit, yh,
                              torch.where(even, yh, (hby - 1) & _U32))
            x2l = torch.where(even, hbx, xl)
            y2l = torch.where(even, yl, hby)
            nxt.append((xl, yl, x1h, y1h, v))
            nxt.append((x2l, y2l, xh, yh, v & ~nosplit))
        pieces = nxt
    zlo = torch.stack([morton_encode(p[0], p[1]) for p in pieces], -1)
    zhi = torch.stack([morton_encode(p[2], p[3]) for p in pieces], -1)
    pv = torch.stack([p[4] for p in pieces], -1)
    return zlo, zhi, pv


def data_bounds(x, y, pad_frac: float = 1e-6):
    """Host helper: tight data bounds, padded so max coords quantize inside."""
    x = np.asarray(x)
    y = np.asarray(y)
    xlo, xhi = float(x.min()), float(x.max())
    ylo, yhi = float(y.min()), float(y.max())
    dx = max(xhi - xlo, 1e-12) * pad_frac
    dy = max(yhi - ylo, 1e-12) * pad_frac
    return (xlo, ylo, xhi + dx, yhi + dy)
