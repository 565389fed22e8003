"""Sharing strategies for ``repro_torch.core.api.Federation``, one class
per answer to *what crosses the wire*:

- :class:`DML`          dense prediction sharing (the paper, Eq. 1/2)
- :class:`SparseDML`    top-k prediction sharing (bandwidth-constrained)
- :class:`DPDML`        clipped + Gaussian-noised predictions with a
                        Renyi (epsilon, delta) accountant
                        (privacy-constrained)
- :class:`TrimmedDML`   trimmed-mean consensus Eq. 2 (Byzantine-robust)
- :class:`MedianDML`    median consensus Eq. 2 (Byzantine-robust)
- :class:`FedAvg`       full weight averaging (baseline #1)
- :class:`AsyncWeights` shallow/deep scheduled weight sharing (baseline #2)

``get_strategy(name, **knobs)`` resolves CLI ids."""
from repro_torch.core.strategies.base import (STRATEGIES, Payload, Strategy,
                                              get_strategy)
from repro_torch.core.strategies.dml import DML, SparseDML
from repro_torch.core.strategies.dp import DPDML
from repro_torch.core.strategies.robust import MedianDML, TrimmedDML
from repro_torch.core.strategies.weights import AsyncWeights, FedAvg

__all__ = ["Strategy", "Payload", "STRATEGIES", "get_strategy",
           "DML", "SparseDML", "DPDML", "TrimmedDML", "MedianDML",
           "FedAvg", "AsyncWeights"]
