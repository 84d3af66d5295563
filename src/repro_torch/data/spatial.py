"""Synthetic spatial dataset generators (paper §5.1.1 stand-ins).

  uniform   ~ SYN  (Spider-style random points)
  gaussian  ~ CHI  (city crime: few dense clusters)
  taxi      ~ NYC  (street-grid-ish anisotropic clusters + arterials)

All generators are seeded and return float32 (x, y) in [0, 1]^2-ish space
so experiments are exactly reproducible.
"""
from __future__ import annotations

import numpy as np


def uniform(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2), dtype=np.float32)
    return pts[:, 0], pts[:, 1]


def gaussian(n: int, seed: int = 0, clusters: int = 12, spread: float = 0.04):
    rng = np.random.default_rng(seed)
    centers = rng.random((clusters, 2))
    weights = rng.dirichlet(np.ones(clusters) * 0.6)
    sizes = rng.multinomial(n, weights)
    xs, ys = [], []
    for c, s in zip(centers, sizes):
        p = rng.normal(c, spread, (s, 2))
        xs.append(p[:, 0])
        ys.append(p[:, 1])
    x = np.clip(np.concatenate(xs), 0, 1).astype(np.float32)
    y = np.clip(np.concatenate(ys), 0, 1).astype(np.float32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def taxi(n: int, seed: int = 0):
    """Anisotropic 'street grid' mixture: dense downtown + arterials."""
    rng = np.random.default_rng(seed)
    n_dt = n // 2
    n_art = n // 4
    n_bg = n - n_dt - n_art
    downtown = rng.normal([0.5, 0.55], [0.05, 0.09], (n_dt, 2))
    t = rng.random(n_art)
    art = np.stack([0.1 + 0.8 * t, 0.3 + 0.35 * t], axis=1)
    art += rng.normal(0, [0.01, 0.03], (n_art, 2))
    bg = rng.random((n_bg, 2))
    pts = np.concatenate([downtown, art, bg])
    pts = np.clip(pts, 0, 1).astype(np.float32)
    perm = rng.permutation(n)
    return pts[perm, 0], pts[perm, 1]


GENERATORS = {"uniform": uniform, "gaussian": gaussian, "taxi": taxi}


def make(kind: str, n: int, seed: int = 0):
    return GENERATORS[kind](n, seed)


def random_rects(n: int, sel: float, bounds, seed: int = 0, centers=None):
    """Query rects with given selectivity (area fraction). If ``centers``
    (x, y arrays) given, rect centers follow the data distribution
    (the paper's 'skewed' queries); else uniform."""
    rng = np.random.default_rng(seed)
    xl, yl, xh, yh = bounds
    w = (xh - xl) * np.sqrt(sel)
    h = (yh - yl) * np.sqrt(sel)
    if centers is None:
        cx = rng.uniform(xl, xh, n)
        cy = rng.uniform(yl, yh, n)
    else:
        ix = rng.integers(0, len(centers[0]), n)
        cx, cy = np.asarray(centers[0])[ix], np.asarray(centers[1])[ix]
    rects = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=1).astype(np.float32)
    return rects


def random_polygons(n: int, bounds, seed: int = 0, max_edges: int = 12,
                    radius: float = 0.03):
    """Star-convex random polygons (possibly concave) + edge counts."""
    rng = np.random.default_rng(seed)
    xl, yl, xh, yh = bounds
    polys = np.zeros((n, max_edges, 2), np.float32)
    n_edges = np.zeros((n,), np.int32)
    for i in range(n):
        e = int(rng.integers(3, max_edges + 1))
        cx = rng.uniform(xl + radius, xh - radius)
        cy = rng.uniform(yl + radius, yh - radius)
        ang = np.sort(rng.uniform(0, 2 * np.pi, e))
        rad = rng.uniform(0.3 * radius, radius, e)
        polys[i, :e, 0] = cx + rad * np.cos(ang)
        polys[i, :e, 1] = cy + rad * np.sin(ang)
        n_edges[i] = e
    return polys, n_edges
