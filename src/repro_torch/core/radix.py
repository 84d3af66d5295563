"""Float-key radix table (paper §3.2 Algorithm 2).

Bucket the key range into 2^b equal cells; ``T[j]`` = index of the first
knot whose bucket >= j. A lookup for key k then searches only the knots
in [T[j], T[j+1]] (j = k's bucket). Built on the host in numpy right
after the spline (core/spline.py), for every partition at once. The
lookup side, ``radix_locate``, is a step of the learned search and lives
with it in ``kernels/spline_search.py``.
"""
from __future__ import annotations

import numpy as np


def build_radix(knot_keys: np.ndarray, n_knots: np.ndarray, *,
                bits: int) -> dict:
    """Build the radix table over each partition's spline knots.

    Args:
      knot_keys: (P, m_pad) f32 knot keys, padded with +3.4e38.
      n_knots:   (P,) int32.
      bits:      table bits b (paper default 10).

    Returns dict with table (P, 2^b+2) int32, kmin (P,) f32,
    scale (P,) f32.
    """
    p_total, m_pad = knot_keys.shape
    size = (1 << bits) + 2
    rows = np.arange(p_total)
    valid = np.arange(m_pad)[None, :] < n_knots[:, None]
    last = np.maximum(n_knots - 1, 0)
    kmin = knot_keys[:, 0]
    kmax = knot_keys[rows, last]
    with np.errstate(over="ignore", invalid="ignore"):
        scale = np.float32(1 << bits) / np.maximum(kmax - kmin,
                                                   np.float32(1e-30))
        bucket = np.floor((knot_keys - kmin[:, None]) * scale[:, None])
    # clamp before the cast; padding knots go past the end and never match
    bucket = np.clip(np.nan_to_num(bucket), 0, 1 << bits).astype(np.int32)
    bucket = np.where(valid, bucket, (1 << bits) + 1)
    # T[j] = first knot index with bucket >= j (rows are sorted)
    js = np.arange(size)
    table = np.stack([np.searchsorted(b, js, side="left") for b in bucket])
    table = np.minimum(table, last[:, None]).astype(np.int32)
    return {"table": table, "kmin": kmin.astype(np.float32),
            "scale": scale.astype(np.float32)}
