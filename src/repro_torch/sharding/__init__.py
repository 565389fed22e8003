"""The client mesh: the port of the ``clients`` mesh of
``repro/sharding/__init__.py`` and ``repro/launch/mesh.py``.

The JAX package runs one controller over a 1-D ``clients`` axis of
devices; each device owns whole clients, and ``shard_map`` runs a round's
body on every device with one ``all_gather`` of the public predictions
between its halves.  The port keeps that single-process design:

  - ``ClientMesh`` is an ordered tuple of ``torch.device``s under one axis
    name, with ``mesh.shape["clients"]`` as in JAX.  A device may appear
    more than once: a mesh of n entries on one card (or on the CPU) runs
    the sharded programs with n slices of the fleet on that device, as
    JAX's fake host devices do in its tests.  On a machine with several
    cards the entries are distinct cards.
  - ``map_entries`` runs a function once per entry, in order, with the
    entry's device current: the loop that replaces ``shard_map``'s body.
    A collective between two halves of a body is the caller's code between
    two ``map_entries`` calls (``core.stacking.gather_clients``).

No process group: one process drives every entry, and CUDA's launches
being asynchronous, the entries of distinct cards overlap.

The logical-axis rules of the JAX module (``get_rules``, ``axis_rules``,
``logical_to_spec``, ``constrain``, ...) name the dry-run's data and model
axes and are not part of the client mesh.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import torch

CLIENT_AXIS = "clients"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh: ``devices`` in entry order (repeats allowed) under the
    one name in ``axis_names``.  Hashable, so a step cache can key on it."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CLIENT_AXIS,)

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(_device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if not self.devices:
            raise ValueError("a client mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a client mesh has one axis, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Sequence) -> ClientMesh:
    """``jax.make_mesh`` for the one 1-D mesh the port has: ``axis_shapes``
    (n,) over the n ``devices``."""
    if len(axis_shapes) != 1 or len(axis_names) != 1:
        raise ValueError(f"only 1-D meshes are ported, got {axis_names} "
                         f"{tuple(axis_shapes)}")
    if int(axis_shapes[0]) != len(devices):
        raise ValueError(f"mesh shape {tuple(axis_shapes)} needs "
                         f"{axis_shapes[0]} devices, got {len(devices)}")
    return ClientMesh(tuple(devices), tuple(axis_names))


def _entry_context(device: torch.device):
    """The entry's device made current for the span (CUDA), or nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def map_entries(mesh: ClientMesh, fn: Callable, *per_entry):
    """``[fn(d, mesh.devices[d], *(a[d] for a in per_entry)) for d]``, each
    call with its entry's device current: ``shard_map``'s body run entry
    by entry.  ``per_entry`` are sequences indexed by entry."""
    out = []
    for d, dev in enumerate(mesh.devices):
        with _entry_context(dev):
            out.append(fn(d, dev, *(a[d] for a in per_entry)))
    return out
