"""Client-stacked tree helpers: the mesh-free part of
``repro/core/stacking.py``.

Every param and optimizer leaf keeps a leading client axis K.  The mesh
helpers (round-robin layout, shard/unshard, gathers) come with the
multi-device slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


def stacked_init(generator: torch.Generator,
                 init_fn: Callable[[torch.Generator], Params],
                 n_clients: int) -> Params:
    """K independent initialisations, stacked on a leading client axis:
    ``init_fn`` draws each client from ``generator`` in turn."""
    return stack_params([init_fn(generator) for _ in range(n_clients)])


def broadcast_stack(params: Params, n_clients: int) -> Params:
    """One tree replicated to a K-stacked tree (clients start from G)."""
    return tree_map(lambda p: p[None].expand(n_clients, *p.shape).clone(),
                    params)


def zeros_like_stack(stacked_params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), stacked_params)


def stacked_sgd_init(stacked_params: Params) -> dict:
    """SGD-momentum state with per-client step counters: (K,) int32."""
    k = tree_leaves(stacked_params)[0].shape[0]
    return {"vel": zeros_like_stack(stacked_params),
            "step": torch.zeros((k,), dtype=torch.int32,
                                device=tree_leaves(stacked_params)[0].device)}


def expand_stack(tree: Params) -> Params:
    """One tree -> a K=1 stacked tree (views; invert with
    ``client_slice(..., 0)``)."""
    return tree_map(lambda p: p[None], tree)


def client_slice(stacked: Params, c: int) -> Params:
    """Client c's view of a stacked tree."""
    return tree_map(lambda p: p[c], stacked)


def client_lerp(old_stacked: Params, new_stacked: Params, mask) -> Params:
    """Per-client select on stacked trees: client c takes ``new`` where
    mask[c] == 1, keeps ``old`` where 0 (partial-participation broadcast);
    the arithmetic of the JAX version, in fp32 then cast back."""
    def sel(a, b):
        m = torch.as_tensor(mask, dtype=torch.float32, device=a.device)
        w = m.reshape((-1,) + (1,) * (a.dim() - 1))
        return (a.float() * (1 - w) + b.float() * w).to(a.dtype)
    return tree_map(sel, old_stacked, new_stacked)


def stack_params(params_list: Sequence[Params]) -> Params:
    """List of per-client trees -> stacked tree (K on axis 0)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def unstack_params(stacked: Params, k: int):
    return [client_slice(stacked, i) for i in range(k)]
