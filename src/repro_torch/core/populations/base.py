"""Shared surface of the client populations a ``Federation`` can run
(``repro/core/populations/base.py``).

A population owns everything model-side of the protocol: the client
parameters and optimizers, the data, the train steps and the device.
Strategies drive it through the capability methods below; a population
advertises which strategies it can execute via ``supported`` and may veto
a pairing in ``validate_strategy``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.strategies.base import NOT_PORTED, not_ported


class Population:
    """Capability/constants surface; concrete populations override."""

    engine_name: str = "population"          # checkpoint meta "engine" tag
    supported: frozenset = frozenset()
    fused_dml: bool = False                  # local+mutual in one update?
    log_participants_always: bool = False    # log the list even at M == K
    bytes_per_position: int = 4              # payload bytes per shared
    #                                          prediction position
    n_clients: int = 0
    rounds: int = 0
    seed: int = 0

    # -- session plumbing --------------------------------------------------
    def validate_strategy(self, strategy) -> None:
        if strategy.name in NOT_PORTED:
            raise not_ported(strategy.name)
        if strategy.name not in self.supported:
            raise ValueError(
                f"{type(self).__name__} does not support strategy "
                f"{strategy.name!r} (supported: {sorted(self.supported)})")

    def begin_round(self, r: int) -> None:
        """Called by the session before each round."""

    def part_mask(self, part: List[int]) -> np.ndarray:
        mask = np.zeros((self.n_clients,), np.float32)
        mask[part] = 1.0
        return mask

    # -- capabilities (strategy-facing) -----------------------------------
    def local_phase(self, r: int, part: List[int], pm) -> List[float]:
        raise NotImplementedError

    def public_payload(self, r: int):
        """Materialise the round's shared public data."""
        raise NotImplementedError

    def mutual_phase(self, r, part, pm, payload, kl_weight, mutual_epochs,
                     sparse_k: int = 0) -> dict:
        raise NotImplementedError

    @property
    def params_per_client(self) -> int:
        raise NotImplementedError

    # -- evaluation / checkpoint ------------------------------------------
    def evaluate(self, history, split=None):
        raise NotImplementedError

    def state_dict(self) -> dict:
        raise NotImplementedError

    def meta_dict(self) -> dict:
        raise NotImplementedError

    def check_meta(self, meta: dict) -> None:
        """Refuse checkpoints whose schedule/population don't match."""

    def load_state_dict(self, state: dict, meta: dict) -> None:
        raise NotImplementedError
