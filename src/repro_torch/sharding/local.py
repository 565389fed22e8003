"""DTensor programs on each rank's local shards: the placement helpers that
the port's data x model mesh computes with where DTensor's own rules would
place the work badly or have none.

  - ``local_call`` runs a function on the local shards of its arguments
    (``local_map``), with the placements each side asks for;
  - ``keep_shards`` / ``drop_shard`` / ``replicated`` build those
    placements;
  - ``sharded_matmul`` is a Megatron layer's product placed as XLA
    partitions it under JAX's rules, ``merge_dims`` a flatten on each
    rank's shard, ``elementwise`` an op without a DTensor rule.

``kernels/ops.py`` wraps each kernel with ``local_call``; the models use
the rest.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def keep_shards(x, dims) -> list:
    """x's placements with ``Shard(d)`` kept for d in ``dims`` where the
    mesh dim divides the size, and ``Replicate()`` everywhere else."""
    out = []
    for p, n in zip(x.placements, x.device_mesh.shape):
        keep = (isinstance(p, Shard) and p.dim in dims
                and x.shape[p.dim] % n == 0)
        out.append(p if keep else Replicate())
    return out


def drop_shard(placements, dim) -> list:
    """``placements`` with any ``Shard(dim)`` replaced by ``Replicate()``."""
    return [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in placements]


def sharded_matmul(x, w):
    """(K, ..., d) @ (K, d, f) -> (K, ..., f) of DTensors, one batched
    product a rank on its shards, placed as XLA partitions a Megatron
    layer under JAX's rules, mesh dim by mesh dim:

      - the client dim (``Shard(0)``) stays sharded on both sides;
      - x's batch shards stay, and a weight whole on that dim is read
        whole there (FSDP: its gradient a partial sum, reduce-scattered
        back to its shard);
      - a weight sharded on f (column parallel: heads, ff, vocab) meets x
        whole on that dim, and the output is sharded on f; x's gradient
        there is a partial sum;
      - a weight sharded on d meets x sharded on its last dim (row
        parallel), and the output is a partial sum.

    The merge of the batch dims is local, so no view of a sharded dim is
    asked of DTensor."""
    from torch.distributed.tensor import Partial
    nd = x.dim()
    xp, wp, op, xg, wg = [], [], [], [], []
    for a, b, n in zip(x.placements, w.placements, x.device_mesh.shape):
        xs = a.dim if isinstance(a, Shard) else None
        ws = b.dim if isinstance(b, Shard) else None
        if ws == 0 or (xs == 0 and w.shape[0] % n == 0):  # the clients
            row = (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0))
        elif xs is not None and 0 < xs < nd - 1 and x.shape[xs] % n == 0:
            row = (a, Replicate(), a, a, Partial())       # x's batch
        elif ws == 2 and w.shape[2] % n == 0:             # column parallel
            row = (Replicate(), b, Shard(nd - 1), Partial(), b)
        elif (ws == 1 or xs == nd - 1) and w.shape[1] % n == 0:
            row = (Shard(nd - 1), Shard(1), Partial(), Shard(nd - 1),
                   Shard(1))                              # row parallel
        else:
            row = (Replicate(),) * 5
        for lst, v in zip((xp, wp, op, xg, wg), row):
            lst.append(v)

    def mm(xl, wl):
        dt = torch.promote_types(xl.dtype, wl.dtype)
        out = torch.matmul(xl.reshape(xl.shape[0], -1, xl.shape[-1]).to(dt),
                           wl.to(dt))
        return out.reshape(*xl.shape[:-1], wl.shape[-1])
    return local_call(mm, op, (xp, wp), x.device_mesh, x, w,
                      grad_placements=(xg, wg))


def merge_dims(w, start: int, end: int):
    """``w.flatten(start, end)``; a DTensor is flattened on each rank's
    shard (an even shard of dim ``start`` stays a shard of the merged
    dim, the merged inner dims are made whole), so that its gradient comes
    back in these placements: DTensor's own view backward refuses to
    split a merged dim whose shard is not whole units of it (40 heads over
    16)."""
    if not isinstance(w, DTensor):
        return w.flatten(start, end)
    place, out = [], []
    for p, n in zip(w.placements, w.device_mesh.shape):
        if not isinstance(p, Shard) or start < p.dim <= end or (
                p.dim == start and w.shape[start] % n):
            place.append(Replicate())
            out.append(Replicate())
        else:
            place.append(p)
            out.append(p if p.dim <= start else Shard(p.dim - end + start))
    return local_call(lambda t: t.flatten(start, end), out, (place,),
                      w.device_mesh, w)


def elementwise(fn, x):
    """``fn`` of one tensor, elementwise, on each rank's shard of a
    DTensor (a partial sum reduced first): for the ops DTensor has no
    rule for (``softplus``'s backward)."""
    if not isinstance(x, DTensor):
        return fn(x)
    place = [p if isinstance(p, Shard) else Replicate()
             for p in x.placements]
    return local_call(fn, place, (place,), x.device_mesh, x)


def replicated(t, mesh):
    """A plain tensor (pair weights) as a replicated DTensor on ``mesh``."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_call(fn, out_placements, in_placements, mesh, *args,
               grad_placements=None):
    """``fn`` on the local shards of ``args`` redistributed to
    ``in_placements`` (None for an argument that is not a tensor); the
    outputs as DTensors of ``out_placements``.  Differentiable: the
    gradients return through the same placements, or through
    ``grad_placements`` where given."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
