"""Federated data plumbing, the port's own copy of
``repro/data/federated.py`` (numpy only; the same seeds give the same
folds and plans): stratified K-folds (Algorithm 1), client shards,
Dirichlet non-IID splits, the per-round public-set rotation, participation
sampling, and the fixed-shape per-round batch plans the stacked round
engine steps through."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def sample_participants(n_clients: int, participation: int, seed: int,
                        round_idx: int) -> List[int]:
    """The M <= K clients sampled for one round (partial participation).

    Stateless in ``round_idx`` — a resumed run samples exactly the same
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


def round_batch_indices(folds: Sequence[np.ndarray], local_epochs: int,
                        batch_size: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-shape batch plan for one round of the stacked round engine.

    ``folds``: one index array per client (possibly ragged).  Returns

      idx  (K, T, B) int64  — gather plan, T = local_epochs * max_c steps_c
                              with steps_c = len(fold_c) // batch_size
      mask (K, T) float32   — 1 where the batch is a real update for that
                              client, 0 where it is shape padding

    Per epoch every client makes one drop-last pass over a fresh
    permutation of its fold — the same batch budget as a per-client Python
    loop.  Clients with fewer examples than the widest client get padding
    steps (cycled indices, masked out of the optimiser update) so the
    whole round is one tensor that all K clients step through together.
    """
    K = len(folds)
    steps = [len(f) // batch_size for f in folds]
    max_steps = max(steps, default=0)
    T = local_epochs * max_steps
    idx = np.zeros((K, T, batch_size), np.int64)
    mask = np.zeros((K, T), np.float32)
    if T == 0:
        return idx, mask
    rng = np.random.default_rng(seed)
    for c, fold in enumerate(folds):
        if len(fold) == 0:
            continue                       # fully masked; zeros never used
        for e in range(local_epochs):
            perm = fold[rng.permutation(len(fold))]
            t0 = e * max_steps
            idx[c, t0:t0 + max_steps] = np.resize(perm,
                                                  (max_steps, batch_size))
            mask[c, t0:t0 + steps[c]] = 1.0
    return idx, mask


class _RoundPlanMixin:
    """Shared ``pop_round``: K client folds popped in Algorithm-1 order,
    compiled into the fixed-shape (K, T, B) plan above."""

    def pop_round(self, n_clients: int, local_epochs: int, batch_size: int,
                  seed: int = 0):
        folds = [self.pop() for _ in range(n_clients)]
        idx, mask = round_batch_indices(folds, local_epochs, batch_size,
                                        seed=seed)
        return folds, idx, mask


def stratified_k_folds(labels: np.ndarray, n_folds: int,
                       seed: int = 0) -> List[np.ndarray]:
    """Index folds preserving class balance (paper line 1:
    Fold <- (1+Clients) x Rounds + 1)."""
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(n_folds)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        for i, chunk in enumerate(np.array_split(idx, n_folds)):
            folds[i].extend(chunk.tolist())
    out = []
    for f in folds:
        arr = np.array(sorted(f), np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


class FoldScheduler(_RoundPlanMixin):
    """Algorithm 1's ``Fold.pop()`` discipline.

    Fold count = (1 + K) * rounds + 1: one fold to initialise the global
    model, then per round one fold per client + one for the global model /
    public mutual-learning set.
    """

    def __init__(self, labels: np.ndarray, n_clients: int, rounds: int,
                 seed: int = 0):
        self.n_folds = (1 + n_clients) * rounds + 1
        self._folds = stratified_k_folds(labels, self.n_folds, seed)
        self._cursor = 0

    def pop(self) -> np.ndarray:
        assert self._cursor < self.n_folds, "fold budget exhausted"
        f = self._folds[self._cursor]
        self._cursor += 1
        return f

    def remaining(self) -> int:
        return self.n_folds - self._cursor

    # fold CONTENTS are deterministic in (labels, K, rounds, seed), so a
    # checkpoint only needs the cursor to resume the rotation exactly
    def state(self) -> dict:
        return {"cursor": self._cursor}

    def load_state(self, st: dict) -> None:
        self._cursor = int(st["cursor"])


class NonIIDScheduler(_RoundPlanMixin):
    """Fold discipline with Dirichlet(alpha) class skew per client
    (the paper's §VI future-work setting).

    Pop-order compatible with Algorithm 1 / FoldScheduler: one shared
    (public/global) fold at init, then per round K client folds followed by
    one shared fold.  Shared folds stay class-balanced (the server's public
    set is public data); each client's folds are drawn from its own skewed
    shard, split across rounds.
    """

    def __init__(self, labels: np.ndarray, n_clients: int, rounds: int,
                 alpha: float = 0.3, seed: int = 0):
        self.n_folds = (1 + n_clients) * rounds + 1
        self.n_clients = n_clients
        self.rounds = rounds
        rng = np.random.default_rng(seed)
        n = len(labels)
        # hold out a balanced pool for the (rounds + 1) shared folds
        shared_pool_size = n * (rounds + 1) // self.n_folds
        order = rng.permutation(n)
        shared_pool, client_pool = order[:shared_pool_size], order[shared_pool_size:]
        shared_folds = stratified_k_folds(labels[shared_pool], rounds + 1,
                                          seed)
        self._shared = [shared_pool[f] for f in shared_folds]
        shards = dirichlet_shards(labels[client_pool], n_clients, alpha,
                                  seed + 1)
        self._client = []
        for shard in shards:
            idx = client_pool[shard]
            rng.shuffle(idx)
            self._client.append(np.array_split(idx, rounds))
        self._round = 0
        self._pos = 0            # 0 = next pop is shared-init / post-round
        self._init_done = False

    def pop(self) -> np.ndarray:
        if not self._init_done:
            self._init_done = True
            return self._shared[0]
        assert self._round < self.rounds, "fold budget exhausted"
        if self._pos < self.n_clients:
            f = self._client[self._pos][self._round]
            self._pos += 1
            return f
        f = self._shared[1 + self._round]
        self._round += 1
        self._pos = 0
        return f

    def remaining(self) -> int:
        used = 1 if self._init_done else 0
        used += self._round * (self.n_clients + 1) + self._pos
        return self.n_folds - used

    def state(self) -> dict:
        return {"round": self._round, "pos": self._pos,
                "init_done": self._init_done}

    def load_state(self, st: dict) -> None:
        self._round = int(st["round"])
        self._pos = int(st["pos"])
        self._init_done = bool(st["init_done"])


def dirichlet_shards(labels: np.ndarray, n_clients: int, alpha: float,
                     seed: int = 0) -> List[np.ndarray]:
    """Non-IID client shards via per-class Dirichlet allocation."""
    rng = np.random.default_rng(seed)
    shards: List[List[int]] = [[] for _ in range(n_clients)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for shard, part in zip(shards, np.split(idx, cuts)):
            shard.extend(part.tolist())
    return [np.array(sorted(s), np.int64) for s in shards]


def iid_shards(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    return [np.sort(part) for part in np.array_split(order, n_clients)]


def public_round_sets(labels: np.ndarray, rounds: int,
                      per_round: int, seed: int = 0) -> List[np.ndarray]:
    """Rotating public test sets — 'dynamically changing test dataset
    provided by the central server ... varies in each round' (paper §III.A)."""
    folds = stratified_k_folds(labels, rounds, seed)
    return [f[:per_round] for f in folds]
