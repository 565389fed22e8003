"""Slot arena: the fixed-shape KV cache the serving engine decodes in.

The arena is one cache tree at a FIXED (slots, max_seq) shape -- ensemble
modes add a leading ``n_models`` axis -- so every admission and retirement
is a slot write, never a reshape.  Attention layers hold a ring buffer of
``min(window, max_seq)`` keys with absolute positions (unwritten entries
are -1 and masked out).  ``write_slot`` overwrites a slot completely at
admission, so a retired request leaves nothing behind for the slot's next
tenant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map


def batch_axis(n_models: int) -> int:
    """Axis carrying the slot (batch) dimension in every arena leaf: cache
    leaves are (n_periods, B, ...), plus a leading client axis when the
    arena serves an ensemble."""
    return 2 if n_models else 1


def init_arena(cfg: ModelConfig, slots: int, max_seq: int,
               window: Optional[int] = None, n_models: int = 0, *, device):
    """Empty arena: ``n_models`` = 0 means a single model (no client axis);
    otherwise every leaf gains a leading stacked-client axis."""
    return tfm.init_cache(cfg, slots, max_seq, window, n_models=n_models,
                          device=device)


def write_slot(arena, one, slot: int, *, axis: int = 1):
    """Copy a freshly prefilled single-request cache into arena slot
    ``slot``, IN PLACE (``index_copy_``), and return the arena.

    ``one`` is the same tree with a size-1 batch axis (a B=1 prefill);
    ``axis`` is the arena's batch axis (``batch_axis(n_models)``).
    """
    def put(a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        idx = torch.tensor([slot], device=a.device)
        return a.index_copy_(axis, idx, o.to(a.dtype))
    return tree_map(put, arena, one)
