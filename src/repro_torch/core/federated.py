"""The paper's Algorithm-1 trainer as a thin wrapper over the session API
(``repro/core/federated.py``).

``FederatedTrainer`` maps the flat ``FederatedConfig`` onto
``Federation(VisionClients(...), cfg.strategy())`` and delegates: its
results are the session's, bit for bit, and its ``save_state`` files are
the session's, so they restore into a ``Federation`` (of either package)
unchanged, and the other way round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.configs.visionnet import VisionNetConfig
from repro_torch.core.api import Federation, History, RoundLog  # noqa: F401
from repro_torch.core.populations.vision import VisionClients
from repro_torch.core.strategies import DML, AsyncWeights, FedAvg


@dataclass
class FederatedConfig:
    method: str = "dml"               # dml | fedavg | async
    n_clients: int = 5
    rounds: int = 12
    local_epochs: int = 2
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    clip_norm: float = 1.0        # the Eq.-1 KL term spikes at sharing time
                                  # (paper Fig. 4c); clipping keeps SGD stable
    # dml
    kl_weight: float = 1.0
    mutual_epochs: int = 1
    # async
    delta: int = 3
    min_round: int = 5
    # partial participation: sample M <= K clients per round (0 -> all K)
    participation: int = 0
    # non-IID client data: Dirichlet(alpha) class skew per client;
    # 0 -> IID stratified folds (the paper's setting)
    non_iid_alpha: float = 0.0
    seed: int = 0
    eval_batch: int = 256

    def strategy(self):
        """The sharing strategy this config names."""
        if self.method == "dml":
            return DML(kl_weight=self.kl_weight,
                       mutual_epochs=self.mutual_epochs)
        if self.method == "fedavg":
            return FedAvg()
        if self.method == "async":
            return AsyncWeights(delta=self.delta, min_round=self.min_round)
        raise ValueError(self.method)


class FederatedTrainer:
    """Legacy facade: ``Federation(VisionClients(...), cfg.strategy())``.

    ``mesh``: an optional ``sharding.ClientMesh`` with a ``clients`` axis:
    the round's training phases then run on its entries (the same
    numbers).  ``device``: where the clients live; ``None`` means the
    CUDA device, as for every entry point of the port.
    """

    def __init__(self, vn_cfg: VisionNetConfig, fed_cfg: FederatedConfig,
                 train_images: np.ndarray, train_labels: np.ndarray,
                 mesh=None, device=None):
        self.vn_cfg = vn_cfg
        self.fed = fed_cfg
        population = VisionClients(
            vn_cfg, train_images, train_labels,
            n_clients=fed_cfg.n_clients, rounds=fed_cfg.rounds,
            local_epochs=fed_cfg.local_epochs,
            batch_size=fed_cfg.batch_size, lr=fed_cfg.lr,
            momentum=fed_cfg.momentum, clip_norm=fed_cfg.clip_norm,
            non_iid_alpha=fed_cfg.non_iid_alpha, seed=fed_cfg.seed,
            eval_batch=fed_cfg.eval_batch, mesh=mesh, device=device)
        self.session = Federation(population, fed_cfg.strategy(),
                                  participation=fed_cfg.participation)

    # -- state views --------------------------------------------------------
    @property
    def _pop(self) -> VisionClients:
        return self.session.population

    @property
    def history(self) -> History:
        return self.session.history

    @property
    def client_params(self):
        return self._pop.client_params

    @property
    def client_opts(self):
        return self._pop.client_opts

    @property
    def global_params(self):
        return self._pop.global_params

    @property
    def global_opt(self):
        return self._pop.global_opt

    @property
    def dispatch_log(self):
        return self._pop.dispatch_log

    @property
    def folds(self):
        return self._pop.folds

    @property
    def mesh(self):
        return self._pop.mesh

    @property
    def n_params(self) -> int:
        return self._pop.n_params

    def participants(self, r: int) -> List[int]:
        return self.session.participants(r)

    # -- the session API ----------------------------------------------------
    def run(self, until: int = 0) -> History:
        return self.session.run(until=until)

    def evaluate(self, test_images: np.ndarray,
                 test_labels: np.ndarray) -> History:
        return self.session.evaluate(split=(test_images, test_labels))

    def save_state(self, path: str) -> None:
        self.session.save_state(path)

    def restore_state(self, path: str) -> None:
        self.session.restore_state(path)
