"""The heterogeneous-client DML trainer as a thin wrapper over the session
API (``repro/core/hetero.py``).

``HeteroTrainer`` keeps the legacy constructor, ``run``, ``evaluate()``
and checkpoint surface over ``Federation(HeteroClients(...),
cfg.strategy())``: its results are the session's, bit for bit, and its
``save_state`` files restore into a ``Federation`` (of either package)
unchanged.  ``make_lm_pool`` and ``comm_bytes_per_round`` re-export from
the population module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.api import Federation, History, RoundLog
from repro_torch.core.populations.hetero import (HeteroClients,
                                                 comm_bytes_per_round,
                                                 make_lm_pool)  # noqa: F401
from repro_torch.core.strategies import DML, SparseDML

# legacy names (the hetero engine predates the unified History)
HeteroHistory = History
HeteroRoundLog = RoundLog


@dataclass
class HeteroConfig:
    """``archs``: one arch id per client; a ``ModelConfig`` object also
    names one (``HeteroClients`` takes either)."""
    archs: Tuple[str, ...] = ("qwen3-4b", "mamba2-780m", "dbrx-132b")
    rounds: int = 4
    local_epochs: int = 1
    batch_size: int = 4
    public_batch: int = 4         # examples of the public fold actually used
    lr: float = 3e-3
    kl_weight: float = 1.0
    mutual_epochs: int = 1
    participation: int = 0        # M <= K clients sampled per round; 0 -> K
    sparse_k: int = 0             # > 0: share top-k predictions (SparseDML)
    seed: int = 0

    @property
    def n_clients(self) -> int:
        return len(self.archs)

    def strategy(self):
        if self.sparse_k:
            return SparseDML(k=self.sparse_k, kl_weight=self.kl_weight,
                             mutual_epochs=self.mutual_epochs)
        return DML(kl_weight=self.kl_weight,
                   mutual_epochs=self.mutual_epochs)


class HeteroTrainer:
    """Legacy facade: ``Federation(HeteroClients(...), cfg.strategy())``.
    ``device``: where the clients live; ``None`` means the CUDA device,
    as for every entry point of the port."""

    def __init__(self, cfg: HeteroConfig, data: np.ndarray,
                 labels: np.ndarray, reduced: bool = True, device=None):
        self.cfg = cfg
        population = HeteroClients(
            cfg.archs, data, labels, rounds=cfg.rounds,
            local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
            public_batch=cfg.public_batch, lr=cfg.lr, seed=cfg.seed,
            mutual_updates_per_round=cfg.mutual_epochs, reduced=reduced,
            device=device)
        self.session = Federation(population, cfg.strategy(),
                                  participation=cfg.participation)

    # -- state views --------------------------------------------------------
    @property
    def _pop(self) -> HeteroClients:
        return self.session.population

    @property
    def history(self) -> History:
        return self.session.history

    @property
    def client_params(self):
        return self._pop.client_params

    @client_params.setter
    def client_params(self, value):
        self._pop.client_params = value

    @property
    def client_opts(self):
        return self._pop.client_opts

    @property
    def n_params(self) -> List[int]:
        return self._pop.n_params

    @property
    def n_classes(self) -> int:
        return self._pop.n_classes

    @property
    def folds(self):
        return self._pop.folds

    @property
    def eval_fold(self):
        return self._pop.eval_fold

    @property
    def _models(self):
        return self._pop._models

    @property
    def _round(self) -> int:
        return self.session.round

    def participants(self, r: int) -> List[int]:
        return self.session.participants(r)

    # -- the session API ----------------------------------------------------
    def run(self, until: int = 0) -> History:
        return self.session.run(until=until)

    def evaluate(self) -> History:
        return self.session.evaluate(split=None)

    def save_state(self, path: str) -> None:
        self.session.save_state(path)

    def restore_state(self, path: str) -> None:
        self.session.restore_state(path)
