"""Spatial-aware partitioners (paper §3.1, Algorithm 1).

Five strategies, built over a ~1% uniform sample on the driver (the paper:
"the master node must maintain all partitions' properties"): fixed grid,
adaptive grid, Quadtree leaves, KD-tree leaves, STR R-tree leaves. Leaf
boxes = "grids"; objects matching no grid go to the OVERFLOW grid with
id == len(grids) (the paper's novel overflow-grid concept — required for
bottom-up R-trees whose sampled leaves need not cover space).

The fitted partitioner is tiny host state (list of boxes); point->grid
assignment is vectorized torch (core/build.py), replacing Spark's per-object
loop with a masked argmax — same first-match semantics as Algorithm 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Box = Tuple[float, float, float, float]  # xl, yl, xh, yh


@dataclasses.dataclass
class Partitioner:
    """Fitted global index: leaf boxes + overflow grid."""

    kind: str
    boxes: np.ndarray          # (G, 4) float32, [xl, yl, xh, yh]
    bounds: Box                # overall data bounds (overflow grid box)

    @property
    def num_grids(self) -> int:
        return int(self.boxes.shape[0])

    @property
    def num_partitions(self) -> int:
        return self.num_grids + 1  # + overflow

    def partition_bounds(self) -> np.ndarray:
        """(G+1, 4) — per-partition boxes; overflow = data bounds."""
        ob = np.asarray(self.bounds, np.float32)[None, :]
        return np.concatenate([self.boxes.astype(np.float32), ob], axis=0)


def _sample(x, y, rate: float, seed: int, min_n: int = 256):
    n = x.shape[0]
    m = max(min(n, min_n), int(n * rate))
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=m, replace=n < m)
    return x[idx], y[idx]


def _bounds(x, y) -> Box:
    pad = 1e-6
    dx = max(float(x.max() - x.min()), 1e-12) * pad
    dy = max(float(y.max() - y.min()), 1e-12) * pad
    return (float(x.min()), float(y.min()),
            float(x.max()) + dx, float(y.max()) + dy)


def fixed_grid(x, y, num_partitions: int, **_) -> Partitioner:
    """g x g uniform tiling of the data bounds."""
    b = _bounds(x, y)
    g = max(int(np.sqrt(num_partitions)), 1)
    xs = np.linspace(b[0], b[2], g + 1)
    ys = np.linspace(b[1], b[3], g + 1)
    boxes = [(xs[i], ys[j], xs[i + 1], ys[j + 1])
             for i in range(g) for j in range(g)]
    return Partitioner("fixed", np.asarray(boxes, np.float32), b)


def adaptive_grid(x, y, num_partitions: int, sample_rate=0.01, seed=0,
                  **_) -> Partitioner:
    """Equi-depth columns in x, equi-depth rows in y per column."""
    sx, sy = _sample(x, y, sample_rate, seed)
    b = _bounds(x, y)
    g = max(int(np.sqrt(num_partitions)), 1)
    xq = np.quantile(sx, np.linspace(0, 1, g + 1))
    xq[0], xq[-1] = b[0], b[2]
    boxes = []
    for i in range(g):
        m = (sx >= xq[i]) & (sx <= xq[i + 1])
        col = sy[m] if m.sum() > 1 else sy
        yq = np.quantile(col, np.linspace(0, 1, g + 1))
        yq[0], yq[-1] = b[1], b[3]
        yq = np.maximum.accumulate(yq)
        for j in range(g):
            boxes.append((xq[i], yq[j], xq[i + 1], yq[j + 1]))
    return Partitioner("adaptive", np.asarray(boxes, np.float32), b)


def kdtree(x, y, num_partitions: int, sample_rate=0.01, seed=0,
           **_) -> Partitioner:
    """Median-split KD-tree leaves over the sample (paper's default)."""
    sx, sy = _sample(x, y, sample_rate, seed)
    b = _bounds(x, y)
    boxes: List[Box] = []

    def split(ix, box, depth, target):
        if target <= 1 or len(ix) <= 1:
            boxes.append(box)
            return
        if depth % 2 == 0:
            med = float(np.median(sx[ix]))
            med = min(max(med, box[0]), box[2])
            l = ix[sx[ix] <= med]
            r = ix[sx[ix] > med]
            b1 = (box[0], box[1], med, box[3])
            b2 = (med, box[1], box[2], box[3])
        else:
            med = float(np.median(sy[ix]))
            med = min(max(med, box[1]), box[3])
            l = ix[sy[ix] <= med]
            r = ix[sy[ix] > med]
            b1 = (box[0], box[1], box[2], med)
            b2 = (box[0], med, box[2], box[3])
        split(l, b1, depth + 1, target // 2)
        split(r, b2, depth + 1, target - target // 2)

    split(np.arange(len(sx)), b, 0, max(num_partitions, 1))
    return Partitioner("kdtree", np.asarray(boxes, np.float32), b)


def quadtree(x, y, num_partitions: int, sample_rate=0.01, seed=0,
             **_) -> Partitioner:
    """Quadtree leaves: recursively 4-split cells holding too many samples."""
    sx, sy = _sample(x, y, sample_rate, seed)
    b = _bounds(x, y)
    cap = max(len(sx) // max(num_partitions, 1), 1)
    boxes: List[Box] = []

    def rec(ix, box, depth):
        if len(ix) <= cap or depth > 12:
            boxes.append(box)
            return
        mx = 0.5 * (box[0] + box[2])
        my = 0.5 * (box[1] + box[3])
        quads = [(box[0], box[1], mx, my), (mx, box[1], box[2], my),
                 (box[0], my, mx, box[3]), (mx, my, box[2], box[3])]
        for q in quads:
            m = ((sx[ix] >= q[0]) & (sx[ix] < q[2]) &
                 (sy[ix] >= q[1]) & (sy[ix] < q[3]))
            rec(ix[m], q, depth + 1)

    rec(np.arange(len(sx)), b, 0)
    return Partitioner("quadtree", np.asarray(boxes, np.float32), b)


def rtree_str(x, y, num_partitions: int, sample_rate=0.01, seed=0,
              **_) -> Partitioner:
    """Sort-Tile-Recursive R-tree LEAVES over the sample.

    Leaf MBRs bound only the sample, so unseen points may fall outside every
    leaf -> overflow grid (paper §3.1). This is the partitioner whose
    existence motivates the overflow concept.
    """
    sx, sy = _sample(x, y, sample_rate, seed)
    b = _bounds(x, y)
    p = max(num_partitions, 1)
    s = max(int(np.ceil(np.sqrt(p))), 1)
    order = np.argsort(sx, kind="stable")
    sx, sy = sx[order], sy[order]
    n = len(sx)
    per_slice = int(np.ceil(n / s))
    boxes: List[Box] = []
    for i in range(0, n, per_slice):
        cx, cy = sx[i:i + per_slice], sy[i:i + per_slice]
        o2 = np.argsort(cy, kind="stable")
        cx, cy = cx[o2], cy[o2]
        per_tile = max(int(np.ceil(len(cx) / s)), 1)
        for j in range(0, len(cx), per_tile):
            tx, ty = cx[j:j + per_tile], cy[j:j + per_tile]
            if len(tx) == 0:
                continue
            boxes.append((float(tx.min()), float(ty.min()),
                          float(tx.max()), float(ty.max())))
    return Partitioner("rtree", np.asarray(boxes, np.float32), b)


STRATEGIES = {
    "fixed": fixed_grid,       # LiLIS-F
    "adaptive": adaptive_grid, # LiLIS-A
    "quadtree": quadtree,      # LiLIS-Q
    "kdtree": kdtree,          # LiLIS-K (paper default)
    "rtree": rtree_str,        # LiLIS-R
}


def fit(kind: str, x, y, num_partitions: int, sample_rate: float = 0.01,
        seed: int = 0) -> Partitioner:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    return STRATEGIES[kind](x, y, num_partitions, sample_rate=sample_rate,
                            seed=seed)
