"""Serving front ends of the port."""
from repro_torch.serve.scheduler import (SpatialScheduler, Ticket,
                                         micro_batch_caps)
from repro_torch.serve.spatial import SpatialServeSession

__all__ = ["SpatialScheduler", "SpatialServeSession", "Ticket",
           "micro_batch_caps"]
