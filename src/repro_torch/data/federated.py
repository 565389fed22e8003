"""Participation sampling, the port's own copy of
``repro/data/federated.py::sample_participants`` (numpy only)."""
from __future__ import annotations

from typing import List

import numpy as np


def sample_participants(n_clients: int, participation: int, seed: int,
                        round_idx: int) -> List[int]:
    """The M <= K clients sampled for one round (partial participation).

    Stateless in ``round_idx`` -- a resumed run samples exactly the same
    subsets as an uninterrupted one.  ``participation`` <= 0 or >= K means
    everyone.  The same (seed, round) names the same subset in both
    packages.
    """
    M = participation or n_clients
    M = min(M, n_clients)
    if M >= n_clients:
        return list(range(n_clients))
    rng = np.random.default_rng(seed * 9973 + 17 + round_idx)
    return sorted(rng.choice(n_clients, size=M, replace=False).tolist())
