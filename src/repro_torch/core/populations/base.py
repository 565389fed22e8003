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

from repro_torch.core import stacking
from repro_torch.tree import tree_leaves


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

    def weights_payload(self, r: int):
        """What a weight strategy's round carries besides the weights: by
        default nothing."""
        return None

    def mutual_phase(self, r, part, pm, payload, kl_weight, mutual_epochs,
                     sparse_k: int = 0, dp=None, robust=None) -> dict:
        """``dp``: a ``privacy.dp.DPSpec`` -- clip + Gaussian-noise each
        client's shared predictions before they cross the boundary
        (DP-DML).  ``robust``: ``(mode, trim)`` -- replace the Eq.-2 mean
        with a trimmed-mean/median consensus target (the Byzantine-robust
        variants).  Populations that list the corresponding strategies in
        ``supported`` honour both."""
        raise NotImplementedError

    def fedavg_combine(self, part: List[int], pm) -> None:
        raise NotImplementedError

    def async_combine(self, r, part, pm, delta, min_round, pub) -> str:
        raise NotImplementedError

    def async_param_counts(self):
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


class MeshState:
    """The client-stacked state (``client_params``, ``client_opts``) of a
    population that may shard its clients over a client mesh
    (``self.mesh``, a ``sharding.ClientMesh`` or None).

    The state is in one of two layouts.  Natural order on ``self.device``
    is what the weight syncs, ``evaluate`` and checkpoints read; the mesh
    phases run on the mesh's entry layout (``stacking.to_entries``), which
    stays between them, as the JAX package keeps a sharded fleet on its
    mesh.  ``_to_mesh`` moves the state to the entries and
    ``_gather_clients_host`` back, each leaf by leaf, so that a full-width
    fleet's state is never held twice; reading or setting
    ``client_params`` / ``client_opts`` gathers first.  A move drops only
    the population's own references: a tree a caller read keeps its
    tensors (and their memory) for as long as the caller holds it.
    """

    mesh = None
    _entries = None            # (params per entry, opts per entry)
    _client_params = None
    _client_opts = None

    @property
    def client_params(self):
        self._gather_clients_host()
        return self._client_params

    @client_params.setter
    def client_params(self, tree):
        self._gather_clients_host()
        self._client_params = tree

    @property
    def client_opts(self):
        self._gather_clients_host()
        return self._client_opts

    @client_opts.setter
    def client_opts(self, tree):
        self._gather_clients_host()
        self._client_opts = tree

    def _gather_clients_host(self) -> None:
        """Commit the state to natural order on ``self.device``."""
        if self._entries is None:
            return
        moves = [([tree_leaves(e) for e in entries],
                  stacking.tree_skeleton(entries[0]))
                 for entries in self._entries]
        self._entries = None
        self._client_params, self._client_opts = [
            stacking.move_from_entries(leaves, skeleton, self.n_clients,
                                       self.device)
            for leaves, skeleton in moves]

    def _to_mesh(self):
        """The state on the mesh's entries: (params, opts) per entry."""
        if self._entries is None:
            moves = [(tree_leaves(t), stacking.tree_skeleton(t))
                     for t in (self._client_params, self._client_opts)]
            self._client_params = self._client_opts = None
            self._entries = tuple(
                stacking.move_to_entries(leaves, skeleton, self.n_clients,
                                         self.mesh.devices)
                for leaves, skeleton in moves)
        return self._entries


def broadcast_mask_counts(stacked_params, mask_tree, n_clients: int):
    """(n_in_mask, n_outside_mask) per client for broadcast-shaped float
    mask trees (``distributed.transformer_shallow_mask``, whose leaves are
    (1, ...) selectors broadcast against the param leaves)."""
    n_in = n_out = 0.0
    for p, m in zip(tree_leaves(stacked_params), tree_leaves(mask_tree)):
        reps = p.numel() / m.numel()       # how often the mask broadcasts
        inside = float(m.float().sum()) * reps
        n_in += inside
        n_out += p.numel() - inside
    return int(round(n_in / n_clients)), int(round(n_out / n_clients))
