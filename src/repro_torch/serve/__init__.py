"""Serving front ends of the port: the spatial session and scheduler,
and LM serving (``api``: prefill, decode, ``generate``,
``ServeSession``)."""
from repro_torch.serve.api import (ServeSession, generate, make_decode,
                                   make_prefill)
from repro_torch.serve.scheduler import (SpatialScheduler, Ticket,
                                         micro_batch_caps)
from repro_torch.serve.spatial import SpatialServeSession

__all__ = ["ServeSession", "SpatialScheduler", "SpatialServeSession",
           "Ticket", "generate", "make_decode", "make_prefill",
           "micro_batch_caps"]
