"""Decoder backbone: init, forward and loss (training), and the serving
prefill/decode.

Layers are ``n_periods`` repetitions of ``cfg.period``; period parameters
are stacked on a leading layer axis, which a Python loop walks (the JAX
package's ``lax.scan``).  A population of K clients is trained and served
by the ``*_clients`` functions, whose params and caches carry a leading
client axis K in front of the layer axis; activations are then
(K, B, S, ...) and each product is one batched call over the clients.
``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` serve one model
(no client axis) through the same code with K = 1.  With ``remat`` each
period runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint`` of the period body), so its activations are recomputed
in the backward.

The slot program dispatches on each slot's mixer, attention
(``models/attention.py``) or a Mamba2 SSD block (``models/ssm.py``), and
on its FFN, a SwiGLU MLP or a mixture of experts (``models/moe.py``), whose
aux losses the training forward sums over the layers.

Prefix-token archs (``cfg.prefix_tokens`` = P > 0: llava-next's image
patches, musicgen's text conditioning) take a precomputed frontend
embedding ``prefix_emb`` (B, P, prefix_dim), shared by the clients, or
(K, B, P, prefix_dim), one per client.  The ``projector`` maps it to
d_model and it stands before the tokens, so positions run over P + S; the
logits at P-1 .. P+S-2 predict tokens[0:], as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_mlp, make_generator, matmul,
                                       mlp_logical_axes, per_client, rms_norm)
from repro_torch.sharding import (axes_map, checkpoint_context, constrain,
                                  distribute_tree)
from repro_torch.sharding.local import keep_shards, local_call, replicated
from repro_torch.trace import span
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def _stack1(tree):
    """A single model's tree as a population of one (a view)."""
    return tree_map(lambda t: t[None], tree)


def _layer(tree, idx: int):
    """Views of layer ``idx`` of a client-stacked (K, n_periods, ...) tree."""
    return tree_map(lambda t: t[:, idx], tree)


# layers whose views ``_layers`` makes at a time
LAYER_GROUP = 8


def _layers(tree, n: int):
    """Yields the views of the ``n`` layers of a client-stacked (K, n, ...)
    tree, a group of ``LAYER_GROUP`` at a time: each leaf's slice of the
    group is unbound into its layers when the forward reaches it.  Under
    autograd a leaf then gathers its gradient one group at a time: a view
    a layer (``_layer``) would add a zero-filled gradient of the whole leaf
    for every layer, and one ``unbind`` of the whole leaf would hold every
    layer's gradient apart until the backward reaches the first layer."""
    leaves = tree_leaves(tree)
    for start in range(0, n, LAYER_GROUP):
        parts = [t[:, start:start + LAYER_GROUP].unbind(1) for t in leaves]
        for i in range(len(parts[0])):
            views = iter([p[i] for p in parts])
            yield tree_map(lambda _: next(views), tree)


# ---------------------------------------------------------------------------
# init

def _init_slot(gen, cfg: ModelConfig, spec, lead):
    zeros = dict(dtype=cfg.pdtype(), device=gen.device)
    p: Params = {"norm1": torch.zeros(lead + (cfg.d_model,), **zeros)}
    if spec.mixer == "attn":
        p["mixer"] = attn_mod.init_attention(gen, cfg, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba(gen, cfg, lead)
    if spec.ffn != "none":
        p["norm2"] = torch.zeros(lead + (cfg.d_model,), **zeros)
    if spec.ffn == "mlp":
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype(), lead)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, lead)
    return p


def init_model(seed: int, cfg: ModelConfig, *, n_clients: int = 0,
               device=None) -> Params:
    """Random params with the JAX package's distributions (truncated-normal
    fan-in, embed N(0, 0.02), zero norms), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default: the CUDA device); on
    ``device="meta"`` nothing is drawn.  The bits differ from JAX's.
    ``n_clients`` > 0 stacks that many independent clients on a leading
    axis."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    lead = (n_clients,) if n_clients else ()
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype(),
                            lead),
        "final_norm": torch.zeros(lead + (cfg.d_model,), dtype=cfg.pdtype(),
                                  device=device),
        "periods": {f"slot{i}": _init_slot(gen, cfg, spec,
                                           lead + (cfg.n_periods,))
                    for i, spec in enumerate(cfg.period)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       cfg.pdtype(), lead=lead)
    if cfg.prefix_tokens:
        params["projector"] = {
            "w": dense_init(gen, (cfg.prefix_dim, cfg.d_model), cfg.pdtype(),
                            lead=lead),
            "b": torch.zeros(lead + (cfg.d_model,), dtype=cfg.pdtype(),
                             device=device)}
    return params


def _slot_logical_axes(cfg: ModelConfig, spec):
    ax: Params = {"norm1": ("embed_act",)}
    if spec.mixer == "attn":
        ax["mixer"] = attn_mod.attention_logical_axes(cfg)
    else:
        ax["mixer"] = ssm_mod.mamba_logical_axes(cfg)
    if spec.ffn != "none":
        ax["norm2"] = ("embed_act",)
        ax["ffn"] = (mlp_logical_axes() if spec.ffn == "mlp"
                     else moe_mod.moe_logical_axes(cfg))
    return ax


def _layered(ax):
    """The stacked layer axis in front of every leaf of a slot tree."""
    return axes_map(lambda t: ("layers",) + t, ax)


def logical_axes(cfg: ModelConfig) -> Params:
    """Tree of logical-axis tuples parallel to ``init_model``'s output of
    one model (``repro/models/transformer.py:91-109``)."""
    ax: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed_act",),
        "periods": {f"slot{i}": _layered(_slot_logical_axes(cfg, spec))
                    for i, spec in enumerate(cfg.period)},
    }
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    if cfg.prefix_tokens:
        ax["projector"] = {"w": (None, "embed"), "b": ("embed_act",)}
    return ax


# ---------------------------------------------------------------------------
# forward

def _ffn(sp, cfg: ModelConfig, spec, x):
    """The slot's FFN on the residual x: (x, aux), aux the MoE's
    {"load_balance", "router_z"} of (K,), or None."""
    if spec.ffn == "none":
        return x, None
    with span("repro.model.ffn"):
        h = rms_norm(x, per_client(sp["norm2"], x), cfg.rms_eps)
        if spec.ffn == "mlp":
            return x + apply_mlp(sp["ffn"], h), None
        y, aux = moe_mod.apply_moe(sp["ffn"], cfg, h)
        return x + y, aux


def _embed_tokens(params, cfg: ModelConfig, tokens):
    """(K, V, d) table and tokens (B, S) shared by the clients, or
    (K, B, S) one batch per client -> (K, B, S, d) in the compute dtype.
    Gathering before the cast equals the JAX cast-then-gather bitwise and
    never casts the whole table."""
    table = params["embed"]
    if isinstance(table, DTensor):
        return _embed_local(table, tokens).to(cfg.cdtype())
    if tokens.dim() == 3:
        clients = torch.arange(table.shape[0], device=tokens.device)
        return table[clients[:, None, None], tokens].to(cfg.cdtype())
    return table[:, tokens].to(cfg.cdtype())


def _embed_local(table, tokens):
    """``_embed_tokens``'s gather from a DTensor table (K, V, d) on each
    rank: the table whole but for its client shard, the tokens' batch
    shard looked up locally (PyTorch 2.11's DTensor has no rule for this
    indexing's backward).  The table's gradient is each rank's rows'
    sum, a partial sum over the mesh dims that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = replicated(tokens, mesh)
    b = tokens.dim() - 2                      # the tokens' batch dim
    tp, wp, op, gp = [], [], [], []
    for p, q, n in zip(table.placements, tokens.placements, mesh.shape):
        client = isinstance(p, Shard) and p.dim == 0
        batch = (not client and isinstance(q, Shard) and q.dim == b
                 and tokens.shape[b] % n == 0)
        wp.append(Shard(0) if client else Replicate())
        tp.append(Shard(0) if client and b else
                  Shard(b) if batch else Replicate())
        op.append(Shard(0) if client else Shard(1) if batch
                  else Replicate())
        gp.append(Shard(0) if client else Partial() if batch
                  else Replicate())

    def gather(w, t):
        if t.dim() == 3:
            rows = torch.arange(w.shape[0], device=t.device)
            return w[rows[:, None, None], t]
        return w[:, t]
    return local_call(gather, op, (wp, tp), mesh, table, tokens,
                      grad_placements=(gp, tp))


def _embed(params, cfg: ModelConfig, tokens, prefix_emb=None):
    """``_embed_tokens``, behind the projected prefix for a prefix-token
    arch: (K, B, P + S, d).  ``prefix_emb`` (B, P, pd) shared or (K, B, P,
    pd) per client is projected in the compute dtype, one batched product
    over the clients, and ``b`` added (``repro/models/transformer.py:
    136-142``).  Archs without a prefix ignore it, as JAX does."""
    x = _embed_tokens(params, cfg, tokens)
    if not cfg.prefix_tokens:
        return constrain(x, "client", "batch", "res_seq", "embed_act")
    if prefix_emb is None:
        raise ValueError(f"{cfg.name} needs a (B, {cfg.prefix_tokens}, "
                         f"{cfg.prefix_dim}) prefix embedding")
    w, b = params["projector"]["w"], params["projector"]["b"]
    pe = prefix_emb.to(device=x.device, dtype=cfg.cdtype())
    lead = pe.shape[0] if pe.dim() == 4 else 1
    dt = torch.promote_types(pe.dtype, w.dtype)
    proj = torch.matmul(pe.reshape(lead, -1, pe.shape[-1]).to(dt), w.to(dt))
    proj = proj + b[:, None].to(dt)
    proj = proj.reshape(w.shape[0], *pe.shape[-3:-1], -1).to(x.dtype)
    return constrain(torch.cat([proj, x], dim=2), "client", "batch",
                     "res_seq", "embed_act")


def _unembed(params, cfg: ModelConfig, x):
    """Final norm, then the head cast to the activations' dtype."""
    x = rms_norm(x, per_client(params["final_norm"], x), cfg.rms_eps)
    logits = matmul(x, _head(params, cfg).to(x.dtype))
    return constrain(logits, "client", "batch", "seq", "vocab")


def _slot(sp, cfg: ModelConfig, i: int, x, positions,
          window: Optional[int], impl: str):
    """Slot ``i`` of the period on x (K, B, S, d) -> (x, load_balance,
    router_z), the aux losses (K,) zero without an MoE FFN."""
    spec = cfg.period[i]
    h = rms_norm(x, per_client(sp["norm1"], x), cfg.rms_eps)
    with span("repro.model.mixer"):
        if spec.mixer == "attn":
            h = attn_mod.attention_forward(sp["mixer"], cfg, h, positions,
                                           window=window, impl=impl)
        else:
            h = ssm_mod.mamba_forward(sp["mixer"], cfg, h, impl=impl)
    x, aux = _ffn(sp, cfg, spec, x + h)
    x = constrain(x, "client", "batch", "res_seq", "embed_act")
    if aux is None:
        zero = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        return x, zero, zero
    return x, aux["load_balance"], aux["router_z"]


def _period(sparams_period, cfg: ModelConfig, x, positions,
            window: Optional[int], impl: str, slot_remat: bool = False):
    """One period of layers on x (K, B, S, d) -> (x, load_balance,
    router_z): the aux losses (K,) summed over the period's slots, returned
    so that a checkpointed period keeps their gradient.  ``slot_remat``
    checkpoints each slot on its own."""
    K = x.shape[0]
    lb = torch.zeros(K, dtype=torch.float32, device=x.device)
    rz = torch.zeros_like(lb)
    for i in range(len(cfg.period)):
        sp = sparams_period[f"slot{i}"]
        if slot_remat:
            x, slb, srz = checkpoint(_slot, sp, cfg, i, x, positions, window,
                                     impl, use_reentrant=False,
                                     context_fn=checkpoint_context)
        else:
            x, slb, srz = _slot(sp, cfg, i, x, positions, window, impl)
        lb, rz = lb + slb, rz + srz
    return x, lb, rz


def forward_hidden_clients(sparams, cfg: ModelConfig, tokens,
                           prefix_emb=None, *, window: Optional[int] = None,
                           remat: bool = True, slot_remat: bool = False,
                           impl: str):
    """Backbone only: final hidden states (K, B, P + S, d), before the
    final norm, and the aux losses {"load_balance", "router_z"} (K,) summed
    over the MoE layers (zeros without any, as the JAX package returns for
    dense layers).  ``tokens`` is (B, S) shared or (K, B, S) per client;
    ``prefix_emb`` as in ``_embed`` (P = 0 without a prefix).  ``remat``
    checkpoints each period, and ``slot_remat`` each slot of a period on
    its own instead (a multi-slot period such as jamba's 8 layers then
    keeps one slot's activations at a time in the backward), when autograd
    records a gradient of the params (not in serving or under
    ``torch.no_grad``).  Neither changes the numbers."""
    with span("repro.model.embed"):
        x = _embed(sparams, cfg, tokens, prefix_emb)
    K, B, S = x.shape[:3]
    positions = torch.arange(S, device=x.device).expand(B, S)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(sparams))
    slot_remat = slot_remat and grad
    remat = remat and grad and not slot_remat
    lb = torch.zeros(K, dtype=torch.float32, device=x.device)
    rz = torch.zeros_like(lb)
    for period in _layers(sparams["periods"], cfg.n_periods):
        if remat:
            x, plb, prz = checkpoint(_period, period, cfg, x, positions,
                                     window, impl, use_reentrant=False,
                                     context_fn=checkpoint_context)
        else:
            x, plb, prz = _period(period, cfg, x, positions, window, impl,
                                  slot_remat)
        lb, rz = lb + plb, rz + prz
    return x, {"load_balance": lb, "router_z": rz}


def forward_clients(sparams, cfg: ModelConfig, tokens, prefix_emb=None, *,
                    window: Optional[int] = None, remat: bool = True,
                    slot_remat: bool = False, impl: str):
    """K clients on tokens (B, S) shared or (K, B, S) per client (and the
    prefix, as in ``_embed``) -> logits (K, B, P + S, V).  (The JAX
    ``forward`` also returns the aux losses; they are
    ``forward_hidden_clients``'s.)"""
    x, _ = forward_hidden_clients(sparams, cfg, tokens, prefix_emb,
                                  window=window, remat=remat,
                                  slot_remat=slot_remat, impl=impl)
    return _unembed(sparams, cfg, x)


def forward_hidden(params, cfg: ModelConfig, tokens, prefix_emb=None, *,
                   window: Optional[int] = None, remat: bool = True,
                   unroll: bool = False, slot_remat: bool = False,
                   impl: str):
    """One model's backbone: tokens (B, S) [, prefix (B, P, pd)] -> the
    final hidden states (B, P + S, d), before the final norm, and the aux
    losses {"load_balance", "router_z"} as scalars.  ``unroll`` is
    accepted for the JAX signature and changes nothing: the layers run as
    a Python loop either way."""
    del unroll
    x, aux = forward_hidden_clients(_stack1(params), cfg, tokens, prefix_emb,
                                    window=window, remat=remat,
                                    slot_remat=slot_remat, impl=impl)
    return x[0], {k: v[0] for k, v in aux.items()}


def forward(params, cfg: ModelConfig, tokens, prefix_emb=None, *,
            window: Optional[int] = None, remat: bool = True,
            slot_remat: bool = False, impl: str):
    """One model: tokens (B, S) [, prefix (B, P, pd)] -> logits
    (B, P + S, V).  (The JAX ``forward`` also returns the aux losses; they
    are ``forward_hidden``'s.)"""
    x, _ = forward_hidden(params, cfg, tokens, prefix_emb, window=window,
                          remat=remat, slot_remat=slot_remat, impl=impl)
    return _unembed(_stack1(params), cfg, x[None])[0]


def _head(params, cfg: ModelConfig):
    """(K, d, V) output head."""
    return (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
            else params["lm_head"])


def chunked_ce(x, head, labels, n_chunks: int = 16):
    """Cross-entropy WITHOUT materialising the (K, B, S, V) logits.

    x: (K, B, S, d) final hidden states; head: (K, d, V); labels: (K, B, S).
    Returns (K,) mean CE per client.  A loop over vocab chunks (slices of
    the head, the last one ragged, so nothing is padded) carries a running
    (max, sum-exp, label-logit); each chunk body is checkpointed, so the
    backward recomputes its logits instead of saving them, as
    ``repro/models/transformer.py::chunked_ce`` does with ``lax.scan``.
    """
    K, B, S, d = x.shape
    V = head.shape[-1]
    c = -(-V // n_chunks)
    xf = x.float().reshape(K, B * S, d)
    lab_idx = labels.reshape(K, B * S)

    def body(m, se, lab, w, base):
        lg = torch.matmul(xf, w.float())           # (K, BS, width of w)
        m_new = torch.maximum(m, lg.max(dim=-1).values)
        se = se * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]) \
            .sum(dim=-1)
        local = lab_idx - base
        inside = (local >= 0) & (local < w.shape[-1])
        picked = torch.gather(lg, -1,
                              local.clamp(0, w.shape[-1] - 1)[..., None])
        return m_new, se, torch.where(inside, picked[..., 0], lab)

    m = torch.full((K, B * S), -1e30, dtype=torch.float32, device=x.device)
    se = torch.zeros_like(m)
    lab = torch.full_like(m, -1e30)
    for i in range(n_chunks):
        w = head[..., i * c:(i + 1) * c]
        if w.shape[-1] == 0:
            break
        if torch.is_grad_enabled():
            m, se, lab = checkpoint(body, m, se, lab, w, i * c,
                                    use_reentrant=False,
                                    context_fn=checkpoint_context)
        else:
            m, se, lab = body(m, se, lab, w, i * c)
    return (m + torch.log(se) - lab).mean(dim=-1)


def _labels(tokens, K: int, prefixed: bool = False):
    """Next-token labels of tokens (B, S) shared or (K, B, S): (K, B, S-1)
    without a prefix, and all S tokens behind one."""
    lab = (tokens if prefixed else tokens[..., 1:]).long()
    return lab.expand(K, *lab.shape[-2:])


def loss_rows(x, P: int):
    """The rows of x (K, B, P + S, ...) whose logits the loss and Eq. 2
    read: all S without a prefix, and P-1 .. P+S-1 behind a prefix of P,
    where the logits at P-1 .. P+S-2 predict tokens[0:]
    (``repro/models/transformer.py:282-287``).  The head runs on these
    rows only: the prefix's other rows predict nothing, and rows are
    independent, so the numbers do not change."""
    return x[:, :, P - 1:] if P else x


def loss_logits(sparams, cfg: ModelConfig, x):
    """Logits (K, B, S or S + 1, V) of ``loss_rows`` of the final hidden
    states x (K, B, P + S, d)."""
    return _unembed(sparams, cfg, loss_rows(x, cfg.prefix_tokens))


def next_token_ce(logits, tokens, prefixed: bool = False):
    """(K,) mean next-token cross-entropy of ``loss_logits`` (K, B, S', V),
    softmax in fp32, on tokens (B, S) shared or (K, B, S) per client: every
    row but the last predicts a token, tokens[1:] (S' = S), or behind a
    prefix tokens[0:] (S' = S + 1)."""
    labels = _labels(tokens, logits.shape[0], prefixed)
    if isinstance(logits, DTensor):
        return _rows_ce(logits, labels).mean(dim=(1, 2))
    logp = torch.log_softmax(logits[:, :, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean(dim=(1, 2))


def _rows_ce(logits, labels):
    """Each row's CE (K, B, S'-1) of DTensor logits (K, B, S', V) on each
    rank's (client, batch) shard, the vocabulary gathered whole: DTensor's
    own gather and slice backward would make a whole-vocab zero gradient
    of the global shape on every rank.  The same arithmetic, row by row."""
    place = keep_shards(logits, {0, 1})

    def ce(lg, lab):
        logp = torch.log_softmax(lg[:, :, :-1].float(), dim=-1)
        return -torch.gather(logp, -1, lab[..., None])[..., 0]
    if not isinstance(labels, DTensor):
        labels = replicated(labels, logits.device_mesh)
    return local_call(ce, place, (place, place), logits.device_mesh,
                      logits, labels)


def loss_fn_clients(sparams, cfg: ModelConfig, tokens, prefix_emb=None, *,
                    window: Optional[int] = None, remat: bool = True,
                    ce_impl: str = "dense", slot_remat: bool = False,
                    impl: str):
    """Next-token cross-entropy of K clients on tokens (B, S) shared or
    (K, B, S) per client, behind ``prefix_emb`` for a prefix-token arch.
    Returns (loss (K,), metrics {"ce", "load_balance", "router_z"} of
    (K,)): the JAX ``loss_fn`` per client.  ce_impl="chunked" streams the
    vocabulary (``chunked_ce``)."""
    x, aux = forward_hidden_clients(sparams, cfg, tokens, prefix_emb,
                                    window=window, remat=remat,
                                    slot_remat=slot_remat, impl=impl)
    prefixed = cfg.prefix_tokens > 0
    with span("repro.model.head"):
        if ce_impl == "chunked":
            x = loss_rows(x, cfg.prefix_tokens)
            x = rms_norm(x, per_client(sparams["final_norm"], x),
                         cfg.rms_eps)
            ce = chunked_ce(x[:, :, :-1], _head(sparams, cfg),
                            _labels(tokens, x.shape[0], prefixed))
        elif ce_impl == "dense":
            ce = next_token_ce(loss_logits(sparams, cfg, x), tokens,
                               prefixed)
        else:
            raise ValueError(f"unknown ce_impl {ce_impl!r}; expected "
                             "'dense' or 'chunked'")
    total = ce + aux["load_balance"] + aux["router_z"]
    return total, {"ce": ce, **aux}


def loss_fn(params, cfg: ModelConfig, tokens, prefix_emb=None, *,
            window: Optional[int] = None, remat: bool = True,
            ce_impl: str = "dense", slot_remat: bool = False, impl: str):
    """One model: tokens (B, S) [, prefix (B, P, pd)] -> (loss, metrics)
    of 0-d tensors."""
    loss, metrics = loss_fn_clients(_stack1(params), cfg, tokens, prefix_emb,
                                    window=window, remat=remat,
                                    ce_impl=ce_impl, slot_remat=slot_remat,
                                    impl=impl)
    return loss[0], {k: v[0] for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               window: Optional[int] = None, *, n_models: int = 0,
               device) -> Params:
    """Cache tree with leaves (n_periods, B, ...), behind a leading client
    axis when ``n_models`` > 0."""
    if window is None:
        window = cfg.sliding_window
    lead = ((n_models,) if n_models else ()) + (cfg.n_periods,)
    return {f"slot{i}": (
        attn_mod.init_kv_cache(cfg, batch, max_seq, window, lead=lead,
                               device=device) if spec.mixer == "attn"
        else ssm_mod.init_mamba_cache(cfg, batch, lead=lead, device=device))
        for i, spec in enumerate(cfg.period)}


def cache_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes of ``init_cache``'s leaves of one model."""
    return {f"slot{i}": _layered(
        attn_mod.kv_cache_logical_axes() if spec.mixer == "attn"
        else ssm_mod.mamba_cache_logical_axes())
        for i, spec in enumerate(cfg.period)}


def prefill_clients(sparams, cfg: ModelConfig, tokens, prefix_emb=None, *,
                    max_seq: int, window: Optional[int] = None, impl: str
                    ) -> Tuple[torch.Tensor, Params]:
    """Prompt ingestion for K clients on shared tokens (B, S), behind the
    prefix (B, P, pd) for a prefix-token arch, which fills the cache's
    first P positions: attention and SSD scans through ``impl``.  (The JAX prefill passes no impl to
    either, so it runs the ambient one.)  MoE FFNs route the prompt in
    groups of min(256, S) tokens, so S must be at most 256 or a multiple of
    it, and their aux losses are dropped, as in the JAX prefill.  Returns
    (last-token logits (K, B, V), cache (K, n_periods, B, ...))."""
    if window is None:
        window = cfg.sliding_window
    with span("repro.model.embed"):
        x = _embed(sparams, cfg, tokens, prefix_emb)
    K, B = x.shape[:2]
    cache = init_cache(cfg, B, max_seq, window, n_models=K, device=x.device)
    if isinstance(x, DTensor):          # on a mesh: the ring's shards
        cache = distribute_tree(cache, axes_map(
            lambda t: ("client",) + t, cache_logical_axes(cfg)),
            x.device_mesh)
    for idx in range(cfg.n_periods):
        period = _layer(sparams["periods"], idx)
        layer_cache = _layer(cache, idx)
        for i, spec in enumerate(cfg.period):
            sp = period[f"slot{i}"]
            h = rms_norm(x, per_client(sp["norm1"], x), cfg.rms_eps)
            c = layer_cache[f"slot{i}"]
            if spec.mixer == "attn":
                out, _ = attn_mod.attention_prefill(
                    sp["mixer"], cfg, h, c, window=window, impl=impl)
            else:
                out, (conv, ssm_state) = ssm_mod.mamba_forward(
                    sp["mixer"], cfg, h, return_state=True, impl=impl)
                c["conv"].copy_(conv)
                c["ssm"].copy_(ssm_state)
            x, _ = _ffn(sp, cfg, spec, x + out)
            x = constrain(x, "client", "batch", "res_seq", "embed_act")
    return _unembed(sparams, cfg, x[:, :, -1:])[:, :, 0], cache


def prefill(params, cfg: ModelConfig, tokens, prefix_emb=None, *,
            max_seq: int, window: Optional[int] = None, impl: str):
    """One model.  Returns (last-token logits (B, V), cache (n_periods, B,
    ...))."""
    logits, cache = prefill_clients(_stack1(params), cfg, tokens, prefix_emb,
                                    max_seq=max_seq, window=window, impl=impl)
    return logits[0], tree_map(lambda t: t[0], cache)


def decode_step_clients(sparams, cfg: ModelConfig, token, cache, pos, *,
                        window: Optional[int] = None):
    """One decode step for K clients.  token: (B, 1) shared; cache: the
    (K, n_periods, B, ...) tree, updated IN PLACE; pos: an int or a (B,)
    tensor of per-sequence positions.  An MoE FFN routes each token alone
    (a group of one: no token is dropped, every expert runs) and its aux
    losses are dropped.  Returns (logits (K, B, V), cache)."""
    if window is None:
        window = cfg.sliding_window
    x = _embed_tokens(sparams, cfg, token)                  # (K, B, 1, d)
    for idx in range(cfg.n_periods):
        period = _layer(sparams["periods"], idx)
        layer_cache = _layer(cache, idx)
        for i, spec in enumerate(cfg.period):
            sp = period[f"slot{i}"]
            h = rms_norm(x, per_client(sp["norm1"], x), cfg.rms_eps)
            if spec.mixer == "attn":
                out, _ = attn_mod.attention_decode(
                    sp["mixer"], cfg, h, layer_cache[f"slot{i}"], pos,
                    window=window)
            else:
                out, _ = ssm_mod.mamba_decode(sp["mixer"], cfg, h,
                                              layer_cache[f"slot{i}"])
            x, _ = _ffn(sp, cfg, spec, x + out)
    return _unembed(sparams, cfg, x)[:, :, 0], cache


def decode_step(params, cfg: ModelConfig, token, cache, pos, *,
                window: Optional[int] = None):
    """One model: token (B, 1); cache (n_periods, B, ...), updated in place.
    Returns (logits (B, V), cache)."""
    logits, _ = decode_step_clients(_stack1(params), cfg, token,
                                    _stack1(cache), pos, window=window)
    return logits[0], cache
