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

The data x model mesh: the logical-axis rules of the JAX module.  Models
name the axes of their params and activations logically (``batch``,
``heads``, ``ff``, ``vocab``, ``client`` ...); ``DEFAULT_RULES`` maps them
to physical mesh axes, ``axis_rules`` overrides the map for a span, and
``logical_to_spec`` gives JAX's ``PartitionSpec`` entries as a tuple.  The
physical meshes are ``torch.distributed`` ``DeviceMesh``es with named
dims (``launch.mesh.make_production_mesh``: ("data", "model") or ("pod",
"data", "model")), one process a rank; the program on them is a DTensor
program:

  - ``logical_to_placements`` turns the spec into one DTensor placement
    a mesh dim (a tensor dim over two mesh axes is ``Shard(i)`` on both);
  - ``use_mesh`` installs the ambient mesh for a span (thread-local) and
    ``current_mesh`` reads it;
  - ``constrain(x, *logical)`` is JAX's ``with_sharding_constraint`` by
    logical names: ``x.redistribute`` to the placements when a mesh is
    current and ``x`` is a DTensor, ``x`` itself otherwise (so every
    unsharded path keeps its numbers bit for bit);
  - ``distribute_tree`` / ``gather_tree`` carry param trees to and from
    DTensors by their logical axes;
  - ``sharding.local`` holds the placement helpers of work run on each
    rank's shards (``local_call``, ``sharded_matmul`` ...).

Not ported: the jax-version shims ``shard_map`` and ``make_mesh``'s axis
types (the client mesh above takes ``shard_map``'s place), and
``current_mesh``'s fallbacks to older JAX state.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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


# ---------------------------------------------------------------------------
# the data x model mesh: logical-axis rules

# Default logical->physical rules (``repro/sharding/__init__.py:23-45``,
# copied exactly).  ``embed`` shards params over the data axis (FSDP,
# ZeRO-3 style); ``heads``/``ff``/``vocab`` are megatron tensor parallel.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": ("pod", "data"),     # standard mode: pure DP across pods
    "attn_batch": ("pod", "data"),  # attention activations; hillclimb remaps
    # FL client axis: a dedicated 1-D "clients" mesh when present, else the
    # multi-pod "pod" axis; remapped in tests
    "client": ("clients", "pod"),
    "seq": None,
    "res_seq": None,     # residual-stream seq dim; "seqpar" variant -> model
    "kv_seq": "model",  # decode KV-cache sequence sharding when heads < tp
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": "data",          # FSDP: param d_model dim over data
    "embed_act": None,        # activation d_model dim stays unsharded
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ff": None,
    "conv": None,
    "state": None,
    "layers": None,
}

_local = threading.local()


def get_rules() -> Dict[str, Optional[str]]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Optional[str]]):
    """Override the logical->physical map for the span, merged over the
    current one (e.g. tests map client->data)."""
    old = get_rules()
    _local.rules = {**old, **rules}
    try:
        yield
    finally:
        _local.rules = old


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh: anything with ``axis_names`` and
    ``axis_sizes`` (JAX's spelling), or a ``DeviceMesh`` with named dims."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


Spec = Tuple[Optional[object], ...]


def logical_to_spec(logical: Tuple[Optional[str], ...], mesh=None,
                    shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Map logical axis names to JAX's ``PartitionSpec`` entries on
    ``mesh``, as a tuple of ``None | str | tuple[str, ...]`` with the
    trailing ``None``s popped.

    Axes not in the rules / not on the mesh / not dividing the dim size are
    dropped (replicated): a tuple rule keeps its greedy prefix whose
    product divides the dim.  A physical axis is used once, first
    occurrence wins.
    """
    rules = get_rules()
    sizes = mesh_axis_sizes(mesh) if mesh is not None else None
    used = set()
    out = []
    for i, name in enumerate(logical):
        phys = rules.get(name) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        cand = (phys,) if isinstance(phys, str) else tuple(phys)
        cand = tuple(a for a in cand
                     if (sizes is None or a in sizes) and a not in used)
        if sizes is not None and shape is not None:
            kept = []
            prod = 1
            for a in cand:
                if shape[i] % (prod * sizes[a]) == 0:
                    kept.append(a)
                    prod *= sizes[a]
            cand = tuple(kept)
        if not cand:
            out.append(None)
            continue
        used.update(cand)
        out.append(cand[0] if len(cand) == 1 else cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_to_placements(logical: Tuple[Optional[str], ...], mesh,
                          shape: Tuple[int, ...]) -> Tuple:
    """One DTensor placement a dim of the ``DeviceMesh``: ``Shard(i)`` on
    every mesh axis that ``logical_to_spec`` gives tensor dim i,
    ``Replicate()`` on the others.  A dim over two axes, ("pod", "data"),
    is sharded over both in the mesh's order, pod major as in JAX."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(logical_to_spec(tuple(logical), mesh, shape)):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def current_mesh():
    """The ambient ``DeviceMesh``, or None when unsharded."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def _installed(mesh, rules):
    """``mesh`` and ``rules`` current for the span; under a mesh a plain
    tensor that meets a DTensor (positions, masks, a zero accumulator the
    program makes) is read as replicated on every rank, as a JAX constant
    is (``implicit_replication``)."""
    old_mesh, old_rules = current_mesh(), get_rules()
    _local.mesh, _local.rules = mesh, rules
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _local.mesh, _local.rules = old_mesh, old_rules


def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the span (a context
    manager that yields it), under the current rules."""
    return _installed(mesh, get_rules())


def checkpoint_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute of a
    checkpointed span sees the mesh and the rules of its forward.  The
    autograd engine runs a CUDA backward on its own device thread, where
    the thread-local mesh is not installed, and a recompute under other
    placements would not match the saved shards."""
    return contextlib.nullcontext(), _installed(current_mesh(), get_rules())


def constrain(x, *logical: Optional[str]):
    """``with_sharding_constraint`` by logical axis names: a DTensor is
    redistributed to the placements of ``logical`` on the current mesh; a
    plain tensor, or any tensor without a mesh, is returned as it is."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if not logical_to_spec(tuple(logical), mesh, x.shape):
        return x
    placements = logical_to_placements(logical, mesh, x.shape)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def local_offset(t, coord=None) -> list:
    """Where the shard of the DTensor ``t`` that the rank at mesh
    coordinate ``coord`` holds (this rank's by default) starts, dim by dim
    (shards even, a dim over several mesh axes split in the mesh's order)."""
    mesh = t.device_mesh
    if coord is None:
        coord = [mesh.get_local_rank(i) for i in range(mesh.ndim)]
    off, size = [0] * t.dim(), list(t.shape)
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(i)
            off[p.dim] += coord[i] * size[p.dim]
    return off


def named_sharding(mesh, *logical, shape=None):
    """(mesh, placements): the DTensor spelling of JAX's
    ``NamedSharding(mesh, logical_to_spec(logical, mesh, shape))``."""
    return mesh, logical_to_placements(tuple(logical), mesh, shape)


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def axes_map(fn: Callable, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a logical-axes tree and trees of the same
    structure (dicts and lists; a tuple of names is one leaf)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: axes_map(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return type(axes_tree)(axes_map(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(axes_tree))


def spec_tree_like(logical_tree, mesh, shape_tree):
    """A tree of (mesh, placements) over a tree of logical-axis tuples and
    one of tensors (or anything with ``.shape``) of the same structure."""
    return axes_map(lambda ax, t: named_sharding(mesh, *ax, shape=t.shape),
                    logical_tree, shape_tree)


def distribute(t, axes, mesh):
    """One tensor as a DTensor on ``mesh`` by its logical axes.  A meta
    tensor becomes a DTensor of meta local shards of the sizes each rank
    would hold (nothing is communicated); any other is cut from the same
    tensor on every rank (``distribute_tensor`` with ``src_data_rank=None``:
    each rank keeps a copy of its own slice)."""
    placements = logical_to_placements(axes, mesh, t.shape)
    if t.is_meta:
        local = list(t.shape)
        for p, n in zip(placements, mesh.shape):
            if isinstance(p, Shard):
                local[p.dim] //= n
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device=t.device), mesh,
            placements, shape=t.shape, stride=t.stride())
    from torch.distributed.tensor import distribute_tensor
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    # a copy of the rank's slice, so that the whole tensor can be freed
    return DTensor.from_local(d.to_local().clone(), mesh, placements,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, axes, mesh):
    """A param (or optimizer, batch, cache) tree as DTensors, each leaf
    placed by its logical axes; leaves that are not tensors (a host step)
    pass through."""
    return axes_map(lambda ax, t: distribute(t, ax, mesh)
                    if isinstance(t, torch.Tensor) else t, axes, tree)


def gather_tree(tree):
    """The inverse of ``distribute_tree``: every DTensor leaf gathered to
    a whole tensor on every rank, other leaves as they are."""
    def leaf(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return leaf(tree)
