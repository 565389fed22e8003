"""Carry weights between the JAX package and the port.

The port keeps the JAX layouts -- ``w_qkv (d, n_qkv, hd)``,
``w_o (H, hd, d)``, ``embed (V, d)``, ``lm_head (d, V)`` -- and keeps the
stacked client axis and the stacked ``(n_periods, ...)`` layer axis, so
carrying weights across is a copy, with no transpose to get wrong.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import unflatten
from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy for torch to own
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, *, device):
    """JAX params (numpy leaves) -> the port's params on ``device``.

    ``tree`` is the nested dict (``jax.tree.map(np.asarray, params)``) or
    the flat dict keyed by the '/'-joined paths of ``repro.checkpoint``.
    bfloat16 leaves (ml_dtypes arrays) cross through a same-width view.
    """
    if any("/" in k for k in tree):
        tree = unflatten(dict(tree))
    return tree_map(lambda a: _tensor(a, device), tree)


def params_to_numpy(params):
    """The inverse of ``params_from_numpy``: a nested dict of numpy arrays.
    bfloat16 leaves come back as ml_dtypes bfloat16 arrays, so that dtype
    must be registered with numpy (importing JAX does so)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
        return t.numpy()
    return tree_map(leaf, params)
