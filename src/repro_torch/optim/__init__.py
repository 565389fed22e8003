"""AdamW with decoupled weight decay, one global-norm clip and schedules
for the LM path, and SGD with momentum for the VisionNet path: the port of
``repro/optim/__init__.py``.

State is a plain dict of trees ({"mu", "nu", "step"}) so it checkpoints in
the JAX package's schema.  Unlike the JAX version, ``adamw_update`` updates
the params and the fp32 moments IN PLACE.  On CUDA leaves the global norm
and the update run in the fused kernels of ``kernels/adamw.py``: one pass
over the gradients for the norm and one over every leaf for the update,
each byte read and written once.  On CPU and meta leaves the update runs
eagerly, the kernels' plain version: one leaf at a time and a large leaf
in runs of ``CHUNK`` elements, so its fp32 temporaries are at most 256 MB
each (a whole leaf's would be 5.4 GB for each MLP matrix of K = 3
full-depth musicgen-medium clients) instead of the whole tree's.
``sgd_update`` takes a client-stacked tree and clips each client by its
own global norm, as the JAX package's ``sgd_update`` does under ``vmap``.

On a data x model mesh the trees are DTensors: the global norm reduces
over every rank's shards (one norm for the whole tree, as unsharded), and
each leaf's update runs on the rank's shards in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import adamw as fused
from repro_torch.trace import count, span, to_host
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# schedules (host-side floats: one learning rate per step for the fleet)

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    return lr


def constant_schedule(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


# ---------------------------------------------------------------------------
# gradient transforms

# elements of a leaf that one elementwise pass of the plain (CPU and meta)
# optimizer takes at a time (its fp32 temporaries are this size)
CHUNK = 1 << 26


def _runs(*ts):
    """Tuples of matching views of equally shaped tensors, in runs of at
    most ``CHUNK`` elements; one tuple of the tensors themselves when they
    are small or one of them is not contiguous.  Elementwise work on the
    runs equals the work on the whole."""
    if ts[0].numel() <= CHUNK or not all(t.is_contiguous() for t in ts):
        return [ts]
    return list(zip(*(t.view(-1).split(CHUNK) for t in ts)))


def _client_runs(scale, *ts):
    """``_runs`` of matching client-stacked tensors, each paired with the
    factor its gradient takes: ``scale`` itself when it is None or 0-d;
    for a (K,) ``scale``, the client's entry, broadcast over a whole small
    leaf, and a leaf of more than ``CHUNK`` elements run client by client
    so that each run lies in one client."""
    if scale is None or scale.dim() == 0:
        return [(r, scale) for r in _runs(*ts)]
    if ts[0].numel() <= CHUNK or not all(t.is_contiguous() for t in ts):
        return [(ts, _per_client(scale, ts[0]))]
    return [(r, scale[c]) for c in range(ts[0].shape[0])
            for r in _runs(*(t[c] for t in ts))]


def _on_cuda(x) -> bool:
    return (x.to_local() if isinstance(x, DTensor) else x).is_cuda


def _mesh_key(x: DTensor) -> tuple:
    """The mesh and the pattern of its dims that shard ``x``: one
    all-reduce completes the partial sums of the leaves that share it."""
    return x.device_mesh, tuple(isinstance(p, Shard) for p in x.placements)


def _complete(local: torch.Tensor, key: tuple) -> torch.Tensor:
    mesh, sharded = key
    return DTensor.from_local(
        local, mesh,
        [Partial() if s else Replicate() for s in sharded]).full_tensor()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor).
    DTensor leaves add their ranks' shards once each: a rank's sum of
    squares is a partial sum over the mesh dims that shard the leaf, and
    one all-reduce a pattern of such dims completes it.  CUDA leaves go
    to the fused norm pass (``_fused_norm``)."""
    leaves = tree_leaves(tree)
    if leaves and _on_cuda(leaves[0]):
        return _fused_norm(leaves)[0]
    return _plain_norm(leaves)


def _plain_norm(leaves) -> torch.Tensor:
    """The fused norm pass's plain version: ``global_norm`` by eager
    passes over runs of at most ``CHUNK`` elements."""
    sq, parts = [], {}
    for x in leaves:
        if isinstance(x, DTensor):
            x = _unpartial(x)
            parts.setdefault(_mesh_key(x), []).extend(
                torch.sum(torch.square(r.float()))
                for (r,) in _runs(x.to_local()))
        else:
            sq.extend(torch.sum(torch.square(r.float())) for (r,) in _runs(x))
    for key, local in parts.items():
        sq.append(_complete(torch.sum(torch.stack(local)), key))
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _fused_norm(leaves, max_norm: Optional[float] = None):
    """(``global_norm`` of CUDA leaves, the clip scale for ``max_norm`` or
    None) through the fused kernels: of plain tensors, one pass writes
    both; DTensors' local sums of squares are completed over their mesh
    as in ``global_norm``."""
    plain, parts = [], {}
    for x in leaves:
        if isinstance(x, DTensor):
            x = _unpartial(x)
            parts.setdefault(_mesh_key(x), []).append(x.to_local())
        else:
            plain.append(x)
    if not parts:
        out = fused.sumsq(plain, clip=max_norm)
        return out[1], None if max_norm is None else out[2]
    sq = [fused.sumsq(plain, norm=False)[0]] if plain else []
    sq += [_complete(fused.sumsq(local, norm=False)[0], key)
           for key, local in parts.items()]
    norm = torch.sqrt(torch.sum(torch.stack(sq)))
    return norm, None if max_norm is None else _clip_scale(norm, max_norm)


def _unpartial(x):
    """A DTensor's partial sums reduced (a gradient may hold one)."""
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def _shards(p, g, mu, nu):
    """A DTensor param's update as its rank's shards: the gradient placed
    as the param first (the moments are); plain tensors as they are."""
    if not isinstance(p, DTensor):
        return p, g, mu, nu
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return tuple(t.to_local() for t in (p, g, mu, nu))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[dict, torch.Tensor]:
    """(grads * min(1, max_norm / norm) in fp32, norm); a new tree."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# AdamW

@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # or "constant"

    def make_schedule(self) -> Callable[[int], float]:
        if self.schedule == "cosine":
            return cosine_schedule(self.lr, self.warmup, self.total_steps)
        return constant_schedule(self.lr)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped (and, for a DTensor, placed) like ``p``."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def adamw_init(params) -> dict:
    """fp32 zero moments shaped like ``params`` and a 0-d int32 step."""
    step_device = tree_leaves(params)[0].device
    return {"mu": tree_map(_zeros32, params),
            "nu": tree_map(_zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def _wd_mask(path: tuple) -> bool:
    """Decay matrices only -- skip norms/biases/scalars (standard practice).
    The name rules of ``repro/optim/__init__.py:81-85``, copied exactly."""
    names = [str(p) for p in path]
    skip = ("norm", "bias", "b_qkv", "A_log", "D", "dt_bias", "conv_b", "b")
    return not any(str(n) in skip or "norm" in str(n) for n in names)


def _leaves_with_path(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and tuples (list positions
    are ints in the path; ``_wd_mask`` reads none of them as a skip
    name, as the JAX package's ``SequenceKey`` is none)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield path, tree
        return
    for k, v in items:
        yield from _leaves_with_path(v, path + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _update_leaves(params, grads, state: dict, cfg: AdamWConfig):
    """(p, g, mu, nu, decay) of each leaf of ``params``, in order: a
    DTensor's as its rank's shards (``_shards``); decay where
    ``cfg.weight_decay`` is set and ``_wd_mask`` takes the path."""
    for path, leaf in _leaves_with_path(params):
        yield (*_shards(leaf, _at(grads, path), _at(state["mu"], path),
                        _at(state["nu"], path)),
               bool(cfg.weight_decay and _wd_mask(path)))


def _plain_update(leaf, scale, lr: float, bc1: float, bc2: float,
                  cfg: AdamWConfig, decay) -> None:
    """The fused update's plain version on one leaf's (p, g, mu, nu):
    eager passes over runs of at most ``CHUNK`` elements, in place."""
    b1, b2 = cfg.b1, cfg.b2
    for (p, g, mu, nu), s in _client_runs(scale, *leaf):
        g = g.float()
        if s is not None:
            g = g * s            # never scales the caller's grads
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        u = torch.sqrt(nu / bc2).add_(cfg.eps)
        u = torch.div(mu, bc1).div_(u)
        if decay:
            u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(u.mul_(-lr).add_(p.float()))      # p - lr * u
        del u


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 client_scale: Optional[torch.Tensor] = None):
    """One AdamW step, IN PLACE on ``params`` and ``state``'s moments.

    The global norm is taken over the whole (client-stacked) ``grads`` tree
    and one clip scale applies to every leaf, as in the JAX package.  A
    (K,) ``client_scale`` instead multiplies each client's gradient by its
    entry, in fp32 (the sharded step's per-client clip); no global norm is
    then taken and "grad_norm" is None.  ``state["step"]`` may be a host
    int, which spares the read of a device step.  CUDA leaves take the
    fused kernels (two launches a table of leaves), counted as
    ``trace.counts["adamw_fused"]``; CPU and meta leaves the plain
    version.  Returns (params, state, {"grad_norm", "lr"}); params and
    state are the objects passed in.
    """
    with span("repro.optim.adamw"):
        first = tree_leaves(params)
        on_cuda = bool(first) and _on_cuda(first[0])
        if on_cuda:      # a leaf the kernels refuse raises before a launch
            leaves = list(_update_leaves(params, grads, state, cfg))
            fused.plan_update(leaves, client_scale)
        gnorm, scale = None, client_scale
        if client_scale is None:
            if on_cuda:
                gnorm, scale = _fused_norm(tree_leaves(grads), cfg.clip_norm)
            else:
                gnorm = global_norm(grads)
                if cfg.clip_norm is not None:
                    scale = _clip_scale(gnorm, cfg.clip_norm)
        state["step"] += 1
        step = state["step"]
        if torch.is_tensor(step):
            step = to_host(step)
        lr = cfg.make_schedule()(step)
        bc1 = 1 - cfg.b1 ** step
        bc2 = 1 - cfg.b2 ** step
        if on_cuda:
            count("adamw_fused")
            fused.update(leaves, scale, lr=lr, b1=cfg.b1, b2=cfg.b2,
                         eps=cfg.eps, weight_decay=cfg.weight_decay,
                         bc1=bc1, bc2=bc2)
        else:
            for *leaf, decay in _update_leaves(params, grads, state, cfg):
                _plain_update(leaf, scale, lr, bc1, bc2, cfg, decay)
        return params, state, {"grad_norm": gnorm,
                               "lr": torch.tensor(lr, dtype=torch.float32)}


# ---------------------------------------------------------------------------
# SGD + momentum (VisionNet path)

@dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.05
    momentum: float = 0.9
    clip_norm: Optional[float] = None


def sgd_init(params) -> dict:
    """fp32 zero velocity shaped like ``params`` and a 0-d int32 step."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"vel": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def _client_sq(x: torch.Tensor) -> torch.Tensor:
    """(K,) fp32 sums of squares of each client's slice of ``x``, a leaf of
    more than ``CHUNK`` elements a client and a run at a time."""
    if x.numel() <= CHUNK:
        return torch.sum(torch.square(x.float()).reshape(x.shape[0], -1),
                         dim=1)
    return torch.stack([torch.sum(torch.stack(
        [torch.sum(torch.square(r.float())) for (r,) in _runs(x[c])]))
        for c in range(x.shape[0])])


def client_norms(tree) -> torch.Tensor:
    """(K,) fp32: for each client of a client-stacked tree, the global norm
    of its slices of every leaf."""
    sq = [_client_sq(x) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq), dim=0))


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def sgd_update(params, grads, state: dict, cfg: SGDConfig):
    """One SGD-momentum step of every client of client-stacked trees: each
    client's gradient is clipped by its own global norm (``client_norms``),
    then vel = momentum * vel + g and p = p - lr * vel, in fp32.  Returns
    new trees (params, {"vel", "step": step + 1}, {"grad_norm": (K,)})."""
    norm = client_norms(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g.float() * _per_client(scale, g), grads)
    vel = tree_map(lambda v, g: cfg.momentum * v + g.float(), state["vel"],
                   grads)
    new_params = tree_map(
        lambda p, v: (p.float() - cfg.lr * v).to(p.dtype), params, vel)
    return new_params, {"vel": vel, "step": state["step"] + 1}, \
        {"grad_norm": norm}
