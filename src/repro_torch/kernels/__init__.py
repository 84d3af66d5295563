"""Hand-written CUDA kernels for Hopper (sm_90a), one module each.

Every module holds the kernel's wrapper (which launches the kernel on
CUDA tensors and runs the plain version on CPU tensors), its plain
PyTorch version, and ``launches``, the number of kernel launches so far
(counted through ``_launches``, exact under threads; a thread capturing
a CUDA graph tallies its launches apart). The CUDA sources live in
``csrc/`` and are built on first use (``_build``).
"""
from __future__ import annotations

from repro_torch.kernels import (_launches, circle_filter, knn_topk,
                                 morton, point_in_polygon, point_probe,
                                 range_filter, spline_search)

# kernel name -> module holding its wrapper and launch count
KERNELS = {
    "spline_search": spline_search,
    "range_count": range_filter,
    "point_probe": point_probe,
    "knn_topk": knn_topk,
    "circle_count": circle_filter,
    "point_in_polygon": point_in_polygon,
    "morton": morton,
}


def launch_counts() -> dict:
    """{kernel name: launches so far}."""
    by_module = _launches.read(KERNELS.values())
    return {name: by_module[mod.__name__] for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    _launches.reset(KERNELS.values())
