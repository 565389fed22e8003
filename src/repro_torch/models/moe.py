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

Aux losses per client: the Switch load-balance loss and the router z-loss.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding import constrain

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


def apply_moe(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    Dict[str, torch.Tensor]]:
    """x (K, B, S, d) -> (y (K, B, S, d) in x's dtype, aux {"load_balance",
    "router_z"} of (K,) fp32): ``repro/models/moe.py::apply_moe`` for each
    client, with per-client weights (K, ...)."""
    m = cfg.moe
    K, B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G = group_size(S)
    N = B * S // G
    C = math.ceil(k * G * m.capacity_factor / E)
    dev = x.device

    logits = torch.matmul(x.reshape(K, N * G, d).float(),
                          params["router"].float())           # (K, NG, E)
    probs = torch.softmax(logits, dim=-1)
    idx, pos, keep = route(probs.view(K, N, G, E), k, C)
    if route_log is not None:
        route_log.append((idx.view(K, N * G, k), keep.view(K, N * G, k)))
    gates = torch.gather(probs, -1, idx.view(K, N * G, k))
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

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

    dt = torch.promote_types(x.dtype, params["w_gate"].dtype)

    def project(h, name):
        """(K, E, rows, a) x the experts (K, E, a, b), client by client."""
        w = params[name]
        return torch.stack([torch.bmm(h[c], w[c].to(dt)) for c in range(K)])

    # JAX's constraints (``repro/models/moe.py:95-100``) on the port's
    # buffers (K, E, N*C, .): the group-major rows keep the batch sharding
    xe = constrain(xe.to(dt), "client", "expert", "batch", None)
    h = F.silu(project(xe, "w_gate")) * project(xe, "w_up")
    h = constrain(h, "client", "expert", "batch", "ff")
    ye = constrain(project(h, "w_down"), "client", "expert", "batch", None)
    ye = ye.reshape(rows, d)
    picked = ye.index_select(0, torch.where(keep, slot, 0)).float()
    w = (gates.reshape(-1) * keep).unsqueeze(-1)             # fp32
    y = (picked * w).view(K * N * G, k, d).sum(1)
    y = y.view(K, B, S, d).to(x.dtype)
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
