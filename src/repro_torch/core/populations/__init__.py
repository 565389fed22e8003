"""Client populations for ``repro_torch.core.api.Federation``:
:class:`LMClients`, the stacked same-arch LM clients over the
``core.distributed`` steps; :class:`VisionClients`, the paper's stacked
VisionNet clients under Algorithm 1 (both on one device or a client
mesh); and :class:`HeteroClients`,
architecture-heterogeneous clients through the per-client model registry.
``Population`` documents the capability surface strategies drive."""
from repro_torch.core.populations.base import Population
from repro_torch.core.populations.hetero import (HeteroClients,
                                                 comm_bytes_per_round,
                                                 make_lm_pool)
from repro_torch.core.populations.lm import LMClients
from repro_torch.core.populations.vision import VisionClients

__all__ = ["Population", "LMClients", "VisionClients", "HeteroClients",
           "comm_bytes_per_round", "make_lm_pool"]
