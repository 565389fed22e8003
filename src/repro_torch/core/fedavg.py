"""Vanilla federated learning (FedAvg, McMahan et al.) -- weight baseline
#1 (``repro/core/fedavg.py``).

Works on client-stacked trees (a leading axis K on every leaf): averaging
is a mean over axis 0 broadcast back, in fp32 and cast back to each leaf's
dtype, as the JAX package does.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def normalised_scores(scores, device) -> torch.Tensor:
    """(K,) fp32 weights: non-negative scores normalised to sum 1."""
    w = torch.as_tensor(scores, dtype=torch.float32, device=device)
    return w / torch.clamp(torch.sum(w), min=1e-9)


def client_mean(p, w=None) -> torch.Tensor:
    """fp32 (1, ...) mean of a stacked leaf over its client axis, weighted
    by ``w`` (K,) when given."""
    pf = p.float()
    if w is None:
        return torch.mean(pf, dim=0, keepdim=True)
    return torch.sum(pf * w.reshape((-1,) + (1,) * (p.dim() - 1)), dim=0,
                     keepdim=True)


def average_weights(stacked_params):
    """Mean over the client axis, broadcast back (FedAvg aggregation)."""
    return tree_map(lambda p: client_mean(p).to(p.dtype).expand(p.shape)
                    .clone(), stacked_params)


def weighted_average_weights(stacked_params, scores):
    """Score-weighted FedAvg (the paper's [4] ``preprocessWeights``):
    scores (K,) non-negative client metrics, normalised to sum 1."""
    def avg(p):
        w = normalised_scores(scores, p.device)
        return client_mean(p, w).to(p.dtype).expand(p.shape).clone()
    return tree_map(avg, stacked_params)


def comm_bytes_per_round(n_params: int, n_clients: int,
                         bytes_per_param: int = 4) -> int:
    """Up + down traffic of one FedAvg round (every client ships all params
    to the server and receives the average back)."""
    return 2 * n_clients * n_params * bytes_per_param
