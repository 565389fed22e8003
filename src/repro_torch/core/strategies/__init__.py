"""Sharing strategies for ``repro_torch.core.api.Federation``, one class
per answer to *what crosses the wire*:

- :class:`DML`          dense prediction sharing (the paper, Eq. 1/2)
- :class:`SparseDML`    top-k prediction sharing (bandwidth-constrained)
- :class:`FedAvg`       full weight averaging (baseline #1)
- :class:`AsyncWeights` shallow/deep scheduled weight sharing (baseline #2)

``get_strategy(name, **knobs)`` resolves CLI ids and names the slice of
the port that brings each of the JAX package's other strategies."""
from repro_torch.core.strategies.base import (NOT_PORTED, STRATEGIES,
                                              Payload, Strategy,
                                              get_strategy)
from repro_torch.core.strategies.dml import DML, SparseDML
from repro_torch.core.strategies.weights import AsyncWeights, FedAvg

__all__ = ["Strategy", "Payload", "STRATEGIES", "NOT_PORTED",
           "get_strategy", "DML", "SparseDML", "FedAvg", "AsyncWeights"]
