"""Asynchronous weight-updating FL, the paper's baseline #2 after [4]
(``repro/core/async_fl.py``).

Algorithm 1's schedule: shallow layers are aggregated every round; deep
layers only when ``(round + 1) % delta == 0 and round >= min_round``.
Aggregation is the metric-weighted average, and ``update_weights``
overwrites only the scheduled param group.  Masks here are trees of one
bool per leaf; the LM population's float masks over the period axis are
``distributed.transformer_shallow_mask``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.fedavg import weighted_average_weights
from repro_torch.tree import tree_leaves, tree_map

Mask = Any  # tree of bools parallel to params


def layer_schedule(round_idx: int, delta: int = 3, min_round: int = 5) -> str:
    """Algorithm 1 lines 12-14: 'shallow' or 'deep' for this round."""
    if (round_idx + 1) % delta == 0 and round_idx >= min_round:
        return "deep"
    return "shallow"


def update_weights(stacked_params, avg_params, shallow_mask: Mask,
                   layer: str):
    """Overwrite the scheduled group with the aggregate: 'shallow' gives
    the shallow-mask leaves the average (every round), 'deep' the others
    (every delta-th round).  Clients never fully sync."""
    want_shallow = layer == "shallow"
    return tree_map(lambda sh, p, a: a if sh == want_shallow else p,
                    shallow_mask, stacked_params, avg_params)


def async_round_update(stacked_params, scores, shallow_mask: Mask,
                       round_idx: int, delta: int = 3, min_round: int = 5):
    """One aggregation of the async baseline on client-stacked params ->
    (params, layer)."""
    layer = layer_schedule(round_idx, delta, min_round)
    avg = weighted_average_weights(stacked_params, scores)
    return update_weights(stacked_params, avg, shallow_mask, layer), layer


def comm_bytes_per_round(n_shallow: int, n_deep: int, n_clients: int,
                         layer: str, bytes_per_param: int = 4) -> int:
    n = n_deep if layer == "deep" else n_shallow
    return 2 * n_clients * n * bytes_per_param


def count_params_by_mask(params, shallow_mask: Mask):
    """(n_shallow, n_deep): parameters in the leaves the mask marks and in
    the others."""
    pairs = list(zip(tree_leaves(params), tree_leaves(shallow_mask)))
    n_shallow = sum(p.numel() for p, m in pairs if m)
    n_deep = sum(p.numel() for p, m in pairs if not m)
    return n_shallow, n_deep
