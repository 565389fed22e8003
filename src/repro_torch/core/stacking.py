"""Client-stacked tree helpers (``repro/core/stacking.py``).

Every param and optimizer leaf keeps a leading client axis K.  The second
half is the client mesh's layout (``sharding.ClientMesh``): clients spill
round-robin over the mesh's entries, the same slot positions, dummy slots
and wrap-around as the JAX package's, and the entry layout that the
sharded programs keep between phases (``to_entries`` / ``drain_entries``).
``chunked_client_map`` is not ported: it pins XLA's lowering to one vmap
width, and PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from repro_torch.sharding import CLIENT_AXIS  # noqa: F401 (re-export)
from repro_torch.tree import tree_leaves, tree_map

Params = Any

# the JAX package's canonical vmap width of the stacked round programs:
# every entry owns a multiple of CLIENT_CHUNK slots, so the slot positions
# and dummies of a layout equal JAX's
CLIENT_CHUNK = 2


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


# ---------------------------------------------------------------------------
# the client mesh's layout: round-robin spill over the entries.
#
# Global client c lives on entry c % n_devices at local slot
# c // n_devices, so an uneven K loads every entry within one client of its
# neighbours.  Every entry owns K_loc slots, a multiple of CLIENT_CHUNK;
# short entries wrap around to re-host a real client as a masked dummy.


def client_layout(n_clients: int, n_devices: int):
    """(K_loc, K_pad) for K clients over an n_devices ``clients`` axis,
    K_loc rounded up to a multiple of ``CLIENT_CHUNK``."""
    k_loc = -(-n_clients // n_devices)
    k_loc = -(-k_loc // CLIENT_CHUNK) * CLIENT_CHUNK
    return k_loc, n_devices * k_loc


def rr_send_indices(n_clients: int, n_devices: int) -> np.ndarray:
    """(K_pad,) gather plan: sharded position p = d * K_loc + i holds global
    client (i * n_devices + d) % K -- dummies wrap to real clients so padded
    forwards stay finite (their updates are masked)."""
    k_loc, k_pad = client_layout(n_clients, n_devices)
    pos = np.arange(k_pad)
    d, i = pos // k_loc, pos % k_loc
    return (i * n_devices + d) % n_clients


def rr_inverse_indices(n_clients: int, n_devices: int) -> np.ndarray:
    """(K_pad,) inverse plan: natural client/pad id c -> sharded position
    (c % n_devices) * K_loc + c // n_devices.  The first K entries undo
    ``rr_send_indices``; the tail locates the dummy slots."""
    k_loc, k_pad = client_layout(n_clients, n_devices)
    c = np.arange(k_pad)
    return (c % n_devices) * k_loc + c // n_devices


def _take(x: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def shard_clients(tree: Params, n_clients: int, n_devices: int,
                  axis: int = 0) -> Params:
    """Natural K-stacked tree -> the K_pad-stacked round-robin layout (a
    copy on the same device)."""
    send = rr_send_indices(n_clients, n_devices)
    return tree_map(lambda x: _take(x, send, axis), tree)


def unshard_clients(tree: Params, n_clients: int, n_devices: int,
                    axis: int = 0) -> Params:
    """Round-robin K_pad layout -> natural K-stacked tree (drops dummies)."""
    inv = rr_inverse_indices(n_clients, n_devices)[:n_clients]
    return tree_map(lambda x: _take(x, inv, axis), tree)


def gather_clients(shards: Sequence[torch.Tensor], n_clients: int,
                   n_devices: int, device) -> torch.Tensor:
    """The all-gather of the entries' (K_loc, ...) shards, entry order,
    onto ``device``, as the full (K_pad, ...) tensor in NATURAL client
    order (pads trailing): the sharded round's only cross-entry traffic
    (the public-set predictions of Eq. 2).  Pass detached shards."""
    x = torch.cat([s.to(device) for s in shards])
    return _take(x, rr_inverse_indices(n_clients, n_devices), 0)


def local_client_ids(n_clients: int, n_devices: int, index: int,
                     device=None) -> torch.Tensor:
    """(K_loc,) int64 global ids of entry ``index``'s slots (ids >=
    n_clients are wrapped dummies); JAX reads the index from
    ``axis_index``."""
    k_loc, _ = client_layout(n_clients, n_devices)
    return torch.arange(k_loc, device=device) * n_devices + index


def entry_rows(n_clients: int, n_devices: int) -> List[np.ndarray]:
    """Per entry, the natural client each of its K_loc slots holds
    (``rr_send_indices`` cut by entry: a dummy holds the client it wraps
    to)."""
    k_loc, _ = client_layout(n_clients, n_devices)
    send = rr_send_indices(n_clients, n_devices)
    return [send[d * k_loc:(d + 1) * k_loc] for d in range(n_devices)]


def tree_skeleton(tree) -> Params:
    """``tree``'s structure with None at every leaf."""
    return tree_map(lambda _: None, tree)


def _unflatten(skeleton, leaves) -> Params:
    it = iter(leaves)
    return tree_map(lambda _: next(it), skeleton)


def _take_all(leaves: list):
    """Each leaf of the list in turn, its slot set to None as it is handed
    out, so that a leaf no one else holds is freed once the consumer
    drops it."""
    for i in range(len(leaves)):
        x, leaves[i] = leaves[i], None
        yield x


def to_entries(tree: Params, n_clients: int,
               devices: Sequence) -> List[Params]:
    """Natural K-stacked tree -> one (K_loc, ...)-stacked tree per mesh
    entry, on that entry's device: ``shard_clients`` cut by entry (a
    copy).  A 0-d leaf (the fleet's shared AdamW step) is replicated, a
    copy per entry, as JAX's ``P()`` spec does."""
    return move_to_entries(tree_leaves(tree), tree_skeleton(tree),
                           n_clients, devices)


def move_to_entries(leaves: list, skeleton, n_clients: int,
                    devices: Sequence) -> List[Params]:
    """``to_entries`` of the tree of ``skeleton``'s structure whose leaves
    are the list ``leaves`` (``tree_leaves`` order), each slot of the list
    set to None as its leaf moves.  A caller that hands over its only
    reference frees the natural layout leaf by leaf, so that a full-width
    fleet's state is never held twice."""
    devices = [torch.device(d) for d in devices]
    rows = entry_rows(n_clients, len(devices))
    pieces = []
    for x in _take_all(leaves):
        if x.dim() == 0:
            pieces.append([x.to(dev, copy=True) for dev in devices])
        else:
            pieces.append([_take(x, r, 0).to(dev)
                           for r, dev in zip(rows, devices)])
        del x
    return [_unflatten(skeleton, [p[d] for p in pieces])
            for d in range(len(devices))]


def drain_entries(entries: list, n_clients: int, device) -> Params:
    """The inverse of ``to_entries`` for a list of entry trees that only
    the caller holds: the natural K-stacked tree on ``device`` (dummies
    dropped; a 0-d leaf taken from entry 0).  The list is emptied first,
    and each leaf is freed as it moves."""
    skeleton = tree_skeleton(entries[0])
    leaves = [tree_leaves(e) for e in entries]
    entries.clear()
    return move_from_entries(leaves, skeleton, n_clients, device)


def move_from_entries(leaves: Sequence[list], skeleton, n_clients: int,
                      device) -> Params:
    """``drain_entries`` of the entry trees of ``skeleton``'s structure
    whose leaves are the lists ``leaves`` (one per entry), each slot set to
    None as its leaf moves (``move_to_entries``'s counterpart)."""
    inv = rr_inverse_indices(n_clients, len(leaves))[:n_clients]
    out = []
    for xs in zip(*(_take_all(ls) for ls in leaves)):
        if xs[0].dim() == 0:
            out.append(xs[0].to(device, copy=True))
        else:
            out.append(_take(torch.cat([x.to(device) for x in xs]), inv, 0))
        del xs
    return _unflatten(skeleton, out)
