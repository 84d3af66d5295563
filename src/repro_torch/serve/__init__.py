"""Serving front ends of the port."""
from repro_torch.serve.spatial import SpatialServeSession

__all__ = ["SpatialServeSession"]
