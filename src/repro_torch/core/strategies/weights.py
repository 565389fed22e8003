"""Weight-sharing strategies (``repro/core/strategies/weights.py``): the
paper's two baselines as protocol objects -- full FedAvg every round, and
the asynchronous shallow/deep schedule of [4].  Both move parameters, so
their comm cost scales with the model's size: the contrast the paper's
bandwidth claim is measured against.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core import async_fl, fedavg
from repro_torch.core.strategies.base import Payload, register


@register
class FedAvg:
    """Vanilla FL: every participant ships all params; the server
    broadcasts the (score-free) average back to the participants."""
    name = "fedavg"

    def local_phase(self, pop, r: int, part: List[int],
                    pm) -> Optional[List[float]]:
        return pop.local_phase(r, part, pm)

    def round_payload(self, pop, r: int, part: List[int]) -> Payload:
        return Payload(kind="weights", data=pop.weights_payload(r))

    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        pop.fedavg_combine(part, pm)
        return {"ran": True}

    def comm_bytes(self, pop, part: List[int], payload: Payload,
                   out: Dict[str, Any]) -> int:
        return fedavg.comm_bytes_per_round(pop.params_per_client,
                                           len(part))


@register
class AsyncWeights:
    """Asynchronous weight-updating FL: metric-weighted average, shallow
    layers every round, deep layers every ``delta``-th round past
    ``min_round`` (``async_fl.layer_schedule``)."""
    name = "async"

    def __init__(self, delta: int = 3, min_round: int = 5):
        self.delta = int(delta)
        self.min_round = int(min_round)

    def local_phase(self, pop, r: int, part: List[int],
                    pm) -> Optional[List[float]]:
        return pop.local_phase(r, part, pm)

    def round_payload(self, pop, r: int, part: List[int]) -> Payload:
        return Payload(kind="weights", data=pop.weights_payload(r))

    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        layer = pop.async_combine(r, part, pm, self.delta, self.min_round,
                                  payload.data)
        return {"ran": True, "layer": layer}

    def comm_bytes(self, pop, part: List[int], payload: Payload,
                   out: Dict[str, Any]) -> int:
        n_shallow, n_deep = pop.async_param_counts()
        return async_fl.comm_bytes_per_round(n_shallow, n_deep, len(part),
                                             out["layer"])
