"""Client populations for ``repro_torch.core.api.Federation``: so far
:class:`LMClients`, the stacked same-arch LM clients over the
``core.distributed`` steps, and :class:`VisionClients`, the paper's
stacked VisionNet clients under Algorithm 1.  ``Population`` documents the
capability surface strategies drive."""
from repro_torch.core.populations.base import Population
from repro_torch.core.populations.lm import LMClients
from repro_torch.core.populations.vision import VisionClients

__all__ = ["Population", "LMClients", "VisionClients"]
