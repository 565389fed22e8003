"""The ``Strategy`` protocol -- *what crosses the wire* as a swappable
choice (``repro/core/strategies/base.py``).

One federated round under ``api.Federation`` is always the same four
protocol steps:

    local_phase    each participant trains on its private data
    round_payload  the strategy declares (and the population materialises)
                   what will cross client boundaries this round
    combine        the cross-client update (Eq.-1 descent against the
                   received predictions, or a weight aggregation)
    comm_bytes     the ledger entry for exactly the payload that moved

Populations expose the capabilities; strategies orchestrate them and own
every protocol hyperparameter (``kl_weight``, ``mutual_epochs``,
``sparse_k``, ``delta``, ...).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@dataclass
class Payload:
    """What one round moves across client boundaries.

    kind      'predictions' | 'sparse-predictions' | 'weights'
    data      population-specific payload source (the LM population: the
              round's public tokens for prediction strategies); may be None
    positions number of shared prediction positions (payload size axis);
              filled by ``combine`` for prediction strategies
    """
    kind: str
    data: Any = None
    positions: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@runtime_checkable
class Strategy(Protocol):
    """Protocol implemented by every sharing strategy.  ``name`` doubles as
    the checkpoint ``method`` tag and the CLI / registry id."""
    name: str

    def local_phase(self, pop, r: int, part: List[int],
                    pm) -> Optional[List[float]]:
        ...

    def round_payload(self, pop, r: int, part: List[int]) -> Payload:
        ...

    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        ...

    def comm_bytes(self, pop, part: List[int], payload: Payload,
                   out: Dict[str, Any]) -> int:
        ...


STRATEGIES: Dict[str, type] = {}


def register(cls):
    STRATEGIES[cls.name] = cls
    return cls


def get_strategy(name: str, **knobs):
    """Resolve a strategy id to a configured instance; knobs the strategy
    does not take are ignored, so one CLI flag namespace drives them all."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"have {sorted(STRATEGIES)}")
    cls = STRATEGIES[name]
    accepted = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in knobs.items() if k in accepted})
