"""Capacity-based top-k mixture-of-experts FFN over a written-out client
axis (``repro/models/moe.py``).

Tokens are routed within groups of ``GROUP_SIZE`` (the sequence itself
when shorter): each group's (token, choice) pairs claim slots of their
experts in row-major order, so token order is the priority, and a choice
past an expert's capacity C = ceil(top_k * G * capacity_factor / E) is
dropped.  The JAX package dispatches with one-hot einsums; here the kept
tokens are copied by index into zero-filled (K, E, N*C, d) capacity
buffers, one ``bmm`` per client and projection runs all its experts (on
the layer's weights in place: a view of the stacked (K, n_periods, E, ...)
leaf cannot merge K and E without copying every expert), and each token
gathers its k outputs back, weighted by its gates in fp32.  The
one-hot sums select exactly one token per slot, so the numbers are JAX's;
only the fp32 combine's order of its <= k terms may differ.  Every expert
takes part in the products (an empty one sees zero rows), so every expert
leaf is in the autograd graph and gets a gradient, zero if it got no token.

On a data x model mesh (a DTensor x) the FFN runs on each rank's shards:
a rank routes its own (client, batch) shard and fills only the rows of the
experts it holds (JAX's constraints, ``repro/models/moe.py:95-100``: the
groups batch-sharded, the experts over ``model``), or, where the experts
do not divide the dim, multiplies every expert's rows by its ``ff``
columns; the combine is then a partial sum over that dim.

Aux losses per client: the Switch load-balance loss and the router z-loss.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding.local import local_call, replicated

GROUP_SIZE = 256

# While a list, every ``apply_moe`` call appends its routes (idx (K, N*G,
# k), keep (K, N*G, k)), in call order: chip_smoke.py counts the routes
# that two paths take differently.  None otherwise.
route_log: Optional[list] = None


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()):
    """The JAX distributions: an fp32 router of std d ** -0.5 whatever the
    param dtype; experts (E, d, de) and (E, de, d) in the param dtype, whose
    fan-in is E (``dense_init``'s rule, as in JAX); the optional shared
    experts a SwiGLU MLP of width n_shared_experts * de."""
    m = cfg.moe
    d, de, E = cfg.d_model, m.d_expert, m.n_experts
    pd = cfg.pdtype()
    p = {
        "router": dense_init(gen, (d, E), torch.float32, scale=d ** -0.5,
                             lead=lead),
        "w_gate": dense_init(gen, (E, d, de), pd, lead=lead),
        "w_up": dense_init(gen, (E, d, de), pd, lead=lead),
        "w_down": dense_init(gen, (E, de, d), pd, lead=lead),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, d, m.n_shared_experts * de, pd, lead)
    return p


def moe_logical_axes(cfg: ModelConfig):
    """Logical axes of ``init_moe``'s leaves
    (``repro/models/moe.py:49-59``)."""
    ax = {
        "router": ("embed", None),
        "w_gate": ("expert", "embed", "ff"),
        "w_up": ("expert", "embed", "ff"),
        "w_down": ("expert", "ff", "embed"),
    }
    if cfg.moe.n_shared_experts:
        ax["shared"] = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                        "w_down": ("ff", "embed")}
    return ax


def group_size(S: int) -> int:
    """Routing group length for a sequence of S tokens.  JAX asserts that
    the groups tile the sequence; padding would change which tokens are
    dropped, so a length that does not tile is refused."""
    G = min(GROUP_SIZE, S)
    if S % G:
        raise ValueError(
            f"MoE routes in groups of {G} tokens: a sequence of {S} must be "
            f"at most {GROUP_SIZE} long or a multiple of {GROUP_SIZE}")
    return G


def route(probs, top_k: int, capacity: int):
    """probs (K, N, G, E) -> (idx (K, N, G*k) int64, pos (K, N, G*k), keep
    (K, N, G*k) bool).  ``idx`` is ``lax.top_k``'s order (probs descending,
    ties to the lower expert: a stable sort; ``torch.topk`` promises no
    order among ties); ``pos`` each (token, choice)'s slot in its expert,
    counted over the group's pairs in row-major order; ``keep`` pos < C."""
    K, N, G, E = probs.shape
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :top_k].reshape(K, N, -1)
    onehot = F.one_hot(idx, E)                               # (K, N, Gk, E)
    pos = torch.gather(onehot.cumsum(2), -1, idx[..., None])[..., 0] - 1
    return idx, pos, pos < capacity


def _route(x, router, top_k: int, capacity: int, G: int):
    """The router on x (K, B, S, d) in groups of G: (logits (K, N*G, E)
    fp32, probs, idx, pos, keep (K, N, G*k), gates (K, N*G, k) fp32, each
    token's k gates renormalised)."""
    K, B, S, d = x.shape
    N = B * S // G
    logits = torch.matmul(x.reshape(K, N * G, d).float(),
                          router.float())                     # (K, NG, E)
    probs = torch.softmax(logits, dim=-1)
    idx, pos, keep = route(probs.view(K, N, G, -1), top_k, capacity)
    gates = torch.gather(probs, -1, idx.view(K, N * G, top_k))
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, idx, pos, keep, gates


def _experts(w_gate, w_up, w_down, x, idx, pos, keep, gates, capacity: int,
             G: int):
    """The experts of ``w_gate`` (K, E, d, de) ... on x (K, B, S, d): the
    kept (token, choice) pairs copied to their slots, the SwiGLU experts,
    and each token's outputs gathered back, weighted by its gates -> y
    (K, B, S, d) in fp32.  ``idx`` indexes ``w_gate``'s E experts; a pair
    whose ``keep`` is False is neither copied nor read."""
    K, B, S, d = x.shape
    E, C = w_gate.shape[1], capacity
    N = B * S // G
    k = gates.shape[-1]
    dev = x.device
    # slot (client c, expert e, group n, position p) is row
    # ((c * E + e) * N + n) * C + p of the capacity buffers; dropped
    # choices write a spare last row and read row 0 with weight 0
    lead = (torch.arange(K, device=dev).view(K, 1, 1) * E + idx) * N
    slot = (lead + torch.arange(N, device=dev).view(1, N, 1)) * C + pos
    rows = K * E * N * C
    slot = slot.reshape(-1)
    keep = keep.reshape(-1)
    src = x.reshape(K * N * G, 1, d).expand(-1, k, -1).reshape(-1, d)
    xe = x.new_zeros(rows + 1, d).index_copy(
        0, torch.where(keep, slot, rows), src)[:rows].view(K, E, N * C, d)

    dt = torch.promote_types(x.dtype, w_gate.dtype)

    def project(h, w):
        """(K, E, rows, a) x the experts (K, E, a, b), client by client."""
        return torch.stack([torch.bmm(h[c], w[c].to(dt)) for c in range(K)])

    xe = xe.to(dt)
    h = F.silu(project(xe, w_gate)) * project(xe, w_up)
    ye = project(h, w_down).reshape(rows, d)
    picked = ye.index_select(0, torch.where(keep, slot, 0)).float()
    w = (gates.reshape(-1) * keep).unsqueeze(-1)             # fp32
    return (picked * w).view(K * N * G, k, d).sum(1).view(K, B, S, d)


def apply_moe(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    Dict[str, torch.Tensor]]:
    """x (K, B, S, d) -> (y (K, B, S, d) in x's dtype, aux {"load_balance",
    "router_z"} of (K,) fp32): ``repro/models/moe.py::apply_moe`` for each
    client, with per-client weights (K, ...).  A DTensor x runs on each
    rank's shards (``_apply_moe_sharded``)."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(params, cfg, x)
    m = cfg.moe
    K, B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G = group_size(S)
    N = B * S // G
    C = math.ceil(k * G * m.capacity_factor / E)

    logits, probs, idx, pos, keep, gates = _route(x, params["router"], k, C,
                                                  G)
    if route_log is not None:
        route_log.append((idx.view(K, N * G, k), keep.view(K, N * G, k)))
    y = _experts(params["w_gate"], params["w_up"], params["w_down"], x, idx,
                 pos, keep, gates, C, G).to(x.dtype)
    if m.n_shared_experts:
        y = y + apply_mlp(params["shared"], x)

    # aux losses per client; the top-k one-hot (before any drop) carries
    # no gradient
    density = F.one_hot(idx, E).sum(dim=(1, 2)).float() / (N * G)
    mean_prob = probs.mean(dim=1)                               # (K, E)
    load_balance = E * (density * mean_prob).sum(-1) * m.aux_coef
    router_z = torch.logsumexp(logits, -1).square().mean(-1) \
        * m.router_z_coef
    return y, {"load_balance": load_balance, "router_z": router_z}


def _whole(t):
    """A DTensor with its partial sums reduced (``Replicate()`` there)."""
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def _apply_moe_sharded(params, cfg: ModelConfig, x):
    """``apply_moe`` of a DTensor x on each rank's shards, in two
    ``local_call``s, the placements chosen mesh dim by mesh dim:

      - the clients (x's or the weights' ``Shard(0)``) stay split on
        every tensor;
      - x's batch split stays: a rank routes its own groups (the groups lie
        within a sequence), exactly as unsharded, with the router and the
        experts read whole there (FSDP: their gradients partial sums,
        reduce-scattered back to their shards);
      - experts split over the dim (``Shard(1)``, E dividing it): the
        tokens whole, a rank fills only its experts' rows of the capacity
        buffers and multiplies them, no all-to-all;
      - ``ff`` split (E not dividing the dim): ``w_gate``/``w_up`` column-
        and ``w_down`` row-parallel over every expert's rows;
      - anything else whole.

    Over an experts or ``ff`` split the combine is a partial sum, reduced
    in fp32 before the cast (XLA reduces JAX's fp32 combine einsum so);
    x's and the gates' gradients from the experts are partial sums there.
    The routing (first call) runs alike on every rank of such a dim, so
    its gradients are whole.  The aux losses take a client's global
    means: each rank's sums of the top-k counts, the probs and the squared
    lse, reduced over the batch split and divided by the client's B*S."""
    m = cfg.moe
    mesh = x.device_mesh
    K, B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G = group_size(S)
    C = math.ceil(k * G * m.capacity_factor / E)
    w = {n: replicated(params[n], mesh)
         for n in ("router", "w_gate", "w_up", "w_down")}
    de = w["w_gate"].shape[3]

    def on(p, dim):
        return isinstance(p, Shard) and p.dim == dim

    R, P = Replicate(), Partial()
    size = {"client": K, "batch": B, "expert": E, "ff": de}
    kinds, n_of = [], {}
    for i, n in enumerate(mesh.shape):
        a, b, c = (x.placements[i], w["w_gate"].placements[i],
                   w["w_down"].placements[i])
        if on(a, 0) or on(b, 0):
            kind = "client"
        elif on(a, 1):
            kind = "batch"
        elif on(b, 1) and on(c, 1):
            kind = "expert"
        elif on(b, 3) and on(c, 2):
            kind = "ff"
        else:
            kind = None
        if kind is not None and size[kind] % (n_of.get(kind, 1) * n):
            kind = None               # does not divide: whole on this dim
        if kind is not None:
            n_of[kind] = n_of.get(kind, 1) * n
        kinds.append(kind)

    def place(**by_kind):
        return [by_kind.get(kd, R) for kd in kinds]

    S0 = Shard(0)
    # x, and the (K, tokens, .) gates, idx and pos: the clients and the
    # batch split; their gradients from the experts partial over a split
    # of the experts or ff
    xp = place(client=S0, batch=Shard(1))
    xg = place(client=S0, batch=Shard(1), expert=P, ff=P)
    sums = place(client=S0, batch=P)
    rp, rg = place(client=S0), place(client=S0, batch=P)
    wp = place(client=S0, expert=Shard(1), ff=Shard(3))
    wg = place(client=S0, batch=P, expert=Shard(1), ff=Shard(3))
    dp = place(client=S0, expert=Shard(1), ff=Shard(2))
    dg = place(client=S0, batch=P, expert=Shard(1), ff=Shard(2))

    def routed(xl, rl):
        logits, probs, idx, pos, _, gates = _route(xl, rl, k, C, G)
        count = F.one_hot(idx, E).sum(dim=(1, 2)).float()
        zsum = torch.logsumexp(logits, -1).square().sum(-1)
        return gates, idx, pos, count, probs.sum(dim=1), zsum

    gates, idx, pos, count, psum, zsum = local_call(
        routed, (xp, xp, xp, sums, sums, sums), (xp, rp), mesh, x,
        w["router"], grad_placements=(xp, rg))
    if route_log is not None:          # every rank: a collective
        route_log.append((idx.full_tensor().view(K, B * S, k),
                          (pos.full_tensor() < C).view(K, B * S, k)))

    def first_expert():
        """This rank's first expert (the experts' dims in mesh order)."""
        off, size = 0, E
        for i, kd in enumerate(kinds):
            if kd == "expert":
                size //= mesh.size(i)
                off += mesh.get_local_rank(i) * size
        return off

    def experts(xl, gl, il, pl, wgl, wul, wdl):
        local = il - first_expert()
        keep = (pl < C) & (local >= 0) & (local < wgl.shape[1])
        return _experts(wgl, wul, wdl, xl, local, pl, keep, gl, C, G)

    y = local_call(experts, xg, (xp, xp, xp, xp, wp, wp, dp), mesh, x,
                   gates, idx, pos, w["w_gate"], w["w_up"], w["w_down"],
                   grad_placements=(xg, xg, xp, xp, wg, wg, dg))
    y = _whole(y).to(x.dtype)
    if m.n_shared_experts:
        y = y + apply_mlp(params["shared"], x)

    count, psum, zsum = _whole(count), _whole(psum), _whole(zsum)
    load_balance = E * ((count / (B * S)) * (psum / (B * S))).sum(-1) \
        * m.aux_coef
    router_z = zsum / (B * S) * m.router_z_coef
    return y, {"load_balance": load_balance, "router_z": router_z}
