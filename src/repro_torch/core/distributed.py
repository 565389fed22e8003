"""Client-stacked federated mutual learning steps: the single-device part
of ``repro/core/distributed.py``.

Clients are a leading K axis on every param and optimizer leaf.  The
cross-client interaction happens ONLY in the Eq.-2 term, on the public
batch's logits (K, B_pub * S, V), whose bytes do not depend on the model's
size -- the paper's bandwidth claim.

Provided steps:
  - ``make_local_train_step``: per-client CE on the private shards
  - ``make_mutual_step``:      Eq. 1 on the public batch
  - ``make_dml_train_step``:   local + mutual fused in one update
Each step's loss is a plain function (``local_total_loss``,
``mutual_total_loss``, ``dml_total_loss``) that tests and ``chip_smoke.py``
can differentiate on their own.  A step returns ``(params, opt,
metrics)``; it updates the params and moments IN PLACE (``adamw_update``)
and returns the same objects.  With ``sparse_k`` the Eq.-2 term is
SparseDML's: each client's top-k (index, log-prob) sets of the detached
public logits, against which every client descends (``_mutual_term``).

The weight-sharing baselines on the client axis: ``fedavg_sync`` and
``async_sync`` (with ``transformer_shallow_mask``) average in fp32 and
write the params IN PLACE.

``make_sharded_dml_step`` runs the fused DML step over a client mesh
(``sharding.ClientMesh``): each entry owns whole clients, and the only
cross-entry tensor is the gathered public logits of the Eq.-2 term.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import stacking
from repro_torch.core.async_fl import layer_schedule
from repro_torch.core.fedavg import client_mean, normalised_scores
from repro_torch.core.mutual import (_pair_mask, mutual_kl_loss,
                                     sparse_mutual_kl_loss, topk_predictions)
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               client_norms)
from repro_torch.sharding import axes_map, axis_rules, constrain, map_entries
from repro_torch.trace import span, to_host
from repro_torch.tree import tree_leaves, tree_map

Params = Any


# ---------------------------------------------------------------------------
# init

def stacked_init(seed: int, cfg: ModelConfig, n_clients: int, *,
                 device=None) -> Params:
    """K independent initialisations on a leading client axis, drawn from
    one ``torch.Generator`` seeded with ``seed``."""
    return tfm.init_model(seed, cfg, n_clients=n_clients, device=device)


def stacked_adamw_init(stacked_params: Params) -> Dict:
    """AdamW state over the stacked params; the scalar step is shared across
    clients (one LR schedule for the whole fleet)."""
    return adamw_init(stacked_params)


def stacked_logical_axes(cfg: ModelConfig) -> Params:
    """``tfm.logical_axes`` behind the ``client`` axis of a stacked tree."""
    return axes_map(lambda t: ("client",) + t, tfm.logical_axes(cfg))


# ---------------------------------------------------------------------------
# losses

def _mask(part_mask, device):
    return 1.0 if part_mask is None else torch.as_tensor(
        part_mask, dtype=torch.float32, device=device)


def _public_ce_and_logits(sparams, cfg: ModelConfig, tokens, prefix,
                          remat: bool, impl: str):
    """Public-batch CE (K,) and the logits (K, B, S, V) of ALL S token
    positions for Eq. 2, the prefix's stripped before it
    (``repro/core/distributed.py:182-194``)."""
    x, _ = tfm.forward_hidden_clients(sparams, cfg, tokens, prefix,
                                      remat=remat, impl=impl)
    prefixed = cfg.prefix_tokens > 0
    with span("repro.model.head"):
        logits = tfm.loss_logits(sparams, cfg, x)
        ce = tfm.next_token_ce(logits, tokens, prefixed)
    return ce, logits[:, :, 1:] if prefixed else logits


def _flat_public(fwd):
    """The public logits (K, B, S, V) as the Eq.-2 term's (K, B*S, V),
    held on the client and vocab axes (``repro/core/distributed.py:163``)."""
    K, B, S, V = fwd.shape
    return constrain(fwd.reshape(K, B * S, V), "client", None, "vocab")


def _client_axis_step(spmd_client_axis):
    """Decorates a step so that it runs with the client dim of every
    client-stacked tensor it constrains held on the mesh axis
    ``spmd_client_axis`` (JAX's ``vmap(..., spmd_axis_name=...)``); the
    step as it is when that is None.  The port has no ``vmap``: the client
    dim is the first of every ``constrain`` in the model."""
    def wrap(step):
        if spmd_client_axis is None:
            return step

        @functools.wraps(step)
        def held(*args, **kw):
            with axis_rules({"client": spmd_client_axis}):
                return step(*args, **kw)
        return held
    return wrap


def _mutual_term(flat, temperature: float, sparse_k: int, part_mask,
                 received, impl: str):
    """Eq. 2 term (K,) of the public logits ``flat`` (K, B*S, V): dense (the
    full logits shared) or SparseDML's top-k sharing
    (``repro/core/distributed.py:118-131``).  The top-k sets are taken from
    the detached logits unless the caller passes the ``received`` (idx,
    logp) sets that crossed the wire."""
    with span("repro.eq2"):
        if not sparse_k:
            return mutual_kl_loss(flat, temperature, part_mask=part_mask,
                                  impl=impl)
        if part_mask is not None:
            raise ValueError("sparse top-k sharing + partial participation "
                             "is not supported by the fused LM step")
        if received is None:
            received = topk_predictions(flat.detach(), sparse_k,
                                        temperature)
        return sparse_mutual_kl_loss(flat, *received, temperature,
                                     impl=impl)


def local_total_loss(sparams, cfg: ModelConfig, tokens, part_mask=None,
                     prefix=None, *, remat: bool = True, impl: str):
    """Private CE summed over the participants: absentees' losses are
    zeroed BEFORE the gradient, so their data reaches nothing, not even
    the shared global-norm clip.  ``prefix`` (K, B, P, pd) for a
    prefix-token arch.  Returns (total, per-client metrics)."""
    losses, metrics = tfm.loss_fn_clients(sparams, cfg, tokens, prefix,
                                          remat=remat, impl=impl)
    return torch.sum(losses * _mask(part_mask, losses.device)), metrics


def mutual_total_loss(sparams, cfg: ModelConfig, public_tokens,
                      part_mask=None, public_prefix=None, *,
                      kl_weight: float = 1.0, temperature: float = 1.0,
                      ce_weight: float = 1.0, remat: bool = True,
                      sparse_k: int = 0, impl: str):
    """Eq. 1 on the public batch: CE(public) + kl_weight * KLD_avg, the
    latter against top-k sets when ``sparse_k`` (``_mutual_term``).
    ``public_prefix`` (B_pub, P, pd) is shared by the clients."""
    ce_pub, fwd = _public_ce_and_logits(sparams, cfg, public_tokens,
                                        public_prefix, remat, impl)
    kl = _mutual_term(_flat_public(fwd), temperature, sparse_k, part_mask,
                      None, impl)
    w = _mask(part_mask, kl.device)
    total = ce_weight * torch.sum(ce_pub * w) + kl_weight * torch.sum(kl)
    return total, {"public_ce": ce_pub.detach(), "kld_avg": kl.detach()}


def dml_total_loss(sparams, cfg: ModelConfig, tokens, public_tokens,
                   part_mask=None, prefix=None, public_prefix=None, *,
                   kl_weight: float = 1.0, temperature: float = 1.0,
                   remat: bool = True, sparse_k: int = 0, received=None,
                   impl: str):
    """One fused DML round's loss: private CE + public CE + kl_weight *
    Eq. 2, summed over the clients (``make_dml_train_step``'s
    ``total_loss``, ``repro/core/distributed.py:222-250``).  ``tokens``
    (K, B, S) private, ``public_tokens`` (B_pub, S) shared; for a
    prefix-token arch ``prefix`` (K, B, P, pd) and ``public_prefix``
    (B_pub, P, pd); ``sparse_k`` and ``received`` as in ``_mutual_term``.
    Returns (total, {"private_loss", "public_ce", "kld_avg"} of (K,))."""
    priv, _ = tfm.loss_fn_clients(sparams, cfg, tokens, prefix, remat=remat,
                                  impl=impl)
    ce_pub, fwd = _public_ce_and_logits(sparams, cfg, public_tokens,
                                        public_prefix, remat, impl)
    kl = _mutual_term(_flat_public(fwd), temperature, sparse_k, part_mask,
                      received, impl)
    w = _mask(part_mask, kl.device)
    total = (torch.sum(priv * w) + torch.sum(ce_pub * w)
             + kl_weight * torch.sum(kl))
    return total, {"private_loss": priv.detach(),
                   "public_ce": ce_pub.detach(), "kld_avg": kl.detach()}


def value_and_grad(loss: Callable, sparams: Params, *args, **kw):
    """``loss(sparams, *args, **kw)`` -> (total, aux), and the gradient of
    total with respect to every leaf of ``sparams`` as a tree: the JAX
    ``value_and_grad(has_aux=True)``.  The leaves require grad for this
    call only."""
    leaves = tree_leaves(sparams)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            with span("repro.step.forward"):
                total, aux = loss(sparams, *args, **kw)
            with span("repro.step.backward"):
                grads = iter(torch.autograd.grad(total, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return total.detach(), aux, tree_map(lambda _: next(grads), sparams)


# ---------------------------------------------------------------------------
# partial participation

def _absent_state(params, opt, part_mask):
    """Copies of the absent clients' rows of params and moments, or None
    under full participation."""
    if part_mask is None:
        return None
    absent = [c for c, m in enumerate(part_mask) if not m]
    if not absent:
        return None
    idx = torch.as_tensor(absent, device=tree_leaves(params)[0].device)
    rows = lambda t: t[idx]                # a copy  # noqa: E731
    return idx, {"params": tree_map(rows, params),
                 "mu": tree_map(rows, opt["mu"]),
                 "nu": tree_map(rows, opt["nu"])}


def _mask_participation(params, opt, absent) -> None:
    """Absent clients keep their params and AdamW moments; the (shared,
    scalar) schedule step keeps advancing.  In place: the rows saved by
    ``_absent_state`` are written back, which is what the JAX package's
    ``client_lerp`` with a 0/1 mask selects."""
    if absent is None:
        return
    idx, old = absent
    for new, saved in ((params, old["params"]), (opt["mu"], old["mu"]),
                       (opt["nu"], old["nu"])):
        for t, s in zip(tree_leaves(new), tree_leaves(saved)):
            t[idx] = s


def _update(params, opt, grads, opt_cfg: AdamWConfig, part_mask):
    absent = _absent_state(params, opt, part_mask)
    params, opt, om = adamw_update(params, grads, opt, opt_cfg)
    _mask_participation(params, opt, absent)
    return params, opt, om


# ---------------------------------------------------------------------------
# steps

def make_local_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                          remat: bool = True, spmd_client_axis=None, *,
                          impl: str):
    """Per-client private-shard CE step: ``step(params, opt, tokens
    (K, B, S), prefix=None, part_mask=None)``, ``prefix`` (K, B, P, pd)
    for a prefix-token arch.  Absentees' params and moments ride through
    unchanged.  On a data x model mesh, ``spmd_client_axis`` names the
    mesh axis that holds the client dim of every client-stacked tensor."""
    @_client_axis_step(spmd_client_axis)
    def step(stacked_params, opt_state, tokens, prefix=None, part_mask=None):
        _, metrics, grads = value_and_grad(
            local_total_loss, stacked_params, cfg, tokens, part_mask, prefix,
            remat=remat, impl=impl)
        params, opt, om = _update(stacked_params, opt_state, grads, opt_cfg,
                                  part_mask)
        return params, opt, {**{k: v.detach() for k, v in metrics.items()},
                             **om}
    return step


def make_mutual_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     kl_weight: float = 1.0, temperature: float = 1.0,
                     remat: bool = True, ce_weight: float = 1.0,
                     sparse_k: int = 0, spmd_client_axis=None, *,
                     impl: str):
    """Eq. 1 on the public batch: ``step(params, opt, public_tokens
    (B_pub, S), public_prefix=None, part_mask=None)``.  Absentees are
    masked out of the Eq.-2 average and their params and moments pass
    through unchanged.  ``spmd_client_axis`` as in
    ``make_local_train_step``."""
    @_client_axis_step(spmd_client_axis)
    def step(stacked_params, opt_state, public_tokens, public_prefix=None,
             part_mask=None):
        _, metrics, grads = value_and_grad(
            mutual_total_loss, stacked_params, cfg, public_tokens, part_mask,
            public_prefix, kl_weight=kl_weight, temperature=temperature,
            ce_weight=ce_weight, remat=remat, sparse_k=sparse_k, impl=impl)
        params, opt, om = _update(stacked_params, opt_state, grads, opt_cfg,
                                  part_mask)
        return params, opt, {**metrics, **om}
    return step


def make_dml_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                        kl_weight: float = 1.0, temperature: float = 1.0,
                        remat: bool = True, sparse_k: int = 0,
                        spmd_client_axis=None, *, impl: str):
    """One fused DML round-step: private CE + Eq. 1 on the public batch in
    one AdamW update with one global-norm clip over the stacked tree.
    ``step(params, opt, tokens (K, B, S), public_tokens (B_pub, S),
    prefix=None, public_prefix=None, part_mask=None)``, the prefixes as in
    ``dml_total_loss``.  ``impl`` is the kernel impl the population
    resolved: it runs the attention forward and backward and the Eq.-2
    term, which is SparseDML's with ``sparse_k`` > 0.  ``spmd_client_axis``
    as in ``make_local_train_step``."""
    @_client_axis_step(spmd_client_axis)
    def step(stacked_params, opt_state, tokens, public_tokens, prefix=None,
             public_prefix=None, part_mask=None):
        _, metrics, grads = value_and_grad(
            dml_total_loss, stacked_params, cfg, tokens, public_tokens,
            part_mask, prefix, public_prefix, kl_weight=kl_weight,
            temperature=temperature, remat=remat, sparse_k=sparse_k,
            impl=impl)
        params, opt, om = _update(stacked_params, opt_state, grads, opt_cfg,
                                  part_mask)
        return params, opt, {**metrics, **om}
    return step


# ---------------------------------------------------------------------------
# the fused step over a client mesh

class ShardedDMLStep:
    """``make_sharded_dml_step``'s step; see there.  ``__call__`` takes
    and returns the natural layout; ``on_entries`` runs on the mesh's entry
    layout (``stacking.to_entries``), which a population keeps between
    rounds."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                 n_clients: int, kl_weight: float, temperature: float,
                 remat: bool, impl: str):
        if cfg.prefix_tokens:
            raise ValueError("sharded DML step: prefix-conditioned archs "
                             "are not supported yet")
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        self.n_clients = n_clients
        self.kl_weight, self.temperature = kl_weight, temperature
        self.remat, self.impl = remat, impl
        self.n_dev = mesh.shape[stacking.CLIENT_AXIS]
        self.k_loc, self.k_pad = stacking.client_layout(n_clients,
                                                        self.n_dev)
        self.rows = stacking.entry_rows(n_clients, self.n_dev)

    def __call__(self, stacked_params, opt_state, tokens, public_tokens,
                 part_mask=None):
        """The natural layout in and out: the state is cut into the entry
        layout, stepped, and written back IN PLACE; returns (params, opt,
        metrics) with the objects passed in."""
        K, devices = self.n_clients, self.mesh.devices
        params = stacking.to_entries(stacked_params, K, devices)
        opts = stacking.to_entries(opt_state, K, devices)
        metrics = self.on_entries(params, opts, tokens, public_tokens,
                                  part_mask)
        with torch.no_grad():
            for tree, entries in ((stacked_params, params),
                                  (opt_state, opts)):
                new = stacking.drain_entries(entries, K, devices[0])
                for t, n in zip(tree_leaves(tree), tree_leaves(new)):
                    t.copy_(n)
        return stacked_params, opt_state, metrics

    def _forward(self, params, tokens, public_tokens):
        """One entry's private CE (K_loc,), public CE (K_loc,) and public
        logits (K_loc, B_pub * S, V), on the autograd tape."""
        cfg = self.cfg
        with span("repro.step.forward"):
            priv, _ = tfm.loss_fn_clients(params, cfg, tokens, None,
                                          remat=self.remat, impl=self.impl)
            ce_pub, fwd = _public_ce_and_logits(params, cfg, public_tokens,
                                                None, self.remat, self.impl)
        k, b, s, v = fwd.shape
        return [priv, ce_pub, fwd.reshape(k, b * s, v)]

    def on_entries(self, params, opts, tokens, public_tokens,
                   part_mask=None) -> Dict:
        """One fused round on the entry layout, IN PLACE: ``params`` and
        ``opts`` are per-entry trees (an opt tree holds "mu", "nu" and the
        entry's copy of the shared "step").  ``tokens`` (K, B, S) and
        ``part_mask`` (K,) in natural order; returns the natural metrics
        ((K,) on the first entry's device, "lr" a 0-d tensor).  The shared
        step is read on the host once a round."""
        step = to_host(opts[0]["step"])
        metrics = self._run(params, tokens, public_tokens, part_mask,
                            lambda d, grads, pm_loc: self._update(
                                params[d], opts[d], grads, pm_loc, step))
        lr = self.opt_cfg.make_schedule()(step + 1)
        return {**metrics, "lr": torch.tensor(lr, dtype=torch.float32)}

    def value_and_grad(self, params, tokens, public_tokens, part_mask=None,
                       device=None):
        """The round's metrics and each client's gradient, with no update:
        (metrics, the gradient tree in natural order on ``device``, the
        first entry's device by default).  The per-client gradients of the
        round's loss equal the unsharded ``dml_total_loss``'s (each
        client's loss terms are its own)."""
        device = self.mesh.devices[0] if device is None else device
        grads = [None] * self.n_dev

        def keep(d, g, pm_loc):
            grads[d] = tree_map(lambda t: t.to(device), g)
            return client_norms(g)

        metrics = self._run(params, tokens, public_tokens, part_mask, keep)
        return metrics, stacking.drain_entries(grads, self.n_clients, device)

    def _run(self, params, tokens, public_tokens, part_mask,
             on_grads) -> Dict:
        """Every entry's forward, then the one gather of the public logits,
        then each entry's Eq.-1 loss on its own clients and its gradient,
        handed to ``on_grads(d, grads, pm_loc)`` (which returns the
        entry's (K_loc,) grad norms) before the next entry's backward.
        The host's small tensors cross to the devices before any work is
        queued (a copy from pageable memory waits for its stream), so that
        the entries of distinct cards overlap."""
        K, mesh = self.n_clients, self.mesh
        pm = torch.ones(K) if part_mask is None else torch.as_tensor(
            part_mask, dtype=torch.float32).cpu()
        pm_nat = torch.zeros(self.k_pad)
        pm_nat[:K] = pm
        pair = _pair_mask(self.k_pad, pm_nat)
        gids = [stacking.local_client_ids(K, self.n_dev, d)
                for d in range(self.n_dev)]
        rows = [torch.as_tensor(r, device=tokens.device) for r in self.rows]
        w_loc = [pm_nat[g].to(dev) for g, dev in zip(gids, mesh.devices)]
        pair_loc = [pair[g].to(dev) for g, dev in zip(gids, mesh.devices)]
        leaves = [tree_leaves(p) for p in params]

        def entry_grads(d, dev, p, fwd, ls):
            priv, ce_pub, flat = fwd
            fwd.clear()                  # the logits die with this entry
            w = w_loc[d]
            with span("repro.step.forward"), span("repro.eq2"):
                kl = torch.mean(ops.mutual_kl_pair(
                    flat, gathered[dev], pair_loc[d],
                    temperature=self.temperature, impl=self.impl), dim=-1)
                total = torch.sum(priv * w) + torch.sum(ce_pub * w) \
                    + self.kl_weight * torch.sum(kl)
            with span("repro.step.backward"):
                it = iter(torch.autograd.grad(total, ls))
            del total, flat
            with torch.no_grad():
                norms = on_grads(d, tree_map(lambda _: next(it), p),
                                 pm_nat[gids[d]])
            return {"private_loss": priv.detach(),
                    "public_ce": ce_pub.detach(), "kld_avg": kl.detach(),
                    "grad_norm": norms}

        for t in (t for ls in leaves for t in ls):
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                fwd = map_entries(mesh, lambda d, dev, p: self._forward(
                    p, tokens.index_select(0, rows[d]).to(dev),
                    public_tokens.to(dev)), params)
                shards = [f[2].detach() for f in fwd]
                with span("repro.step.gather"):
                    gathered = {dev: stacking.gather_clients(
                        shards, K, self.n_dev, dev)
                        for dev in set(mesh.devices)}
                del shards
                out = map_entries(mesh, entry_grads, params, fwd, leaves)
        finally:
            for t in (t for ls in leaves for t in ls):
                t.requires_grad_(False)
        with span("repro.step.gather"):
            return {key: stacking.gather_clients(
                [m[key] for m in out], K, self.n_dev, mesh.devices[0])[:K]
                for key in ("private_loss", "public_ce", "kld_avg",
                            "grad_norm")}

    def _update(self, params, opt, grads, pm_loc, step: int):
        """AdamW on an entry's participating slots, each client's gradient
        clipped by its own norm (JAX: ``vmap(clip_by_global_norm)``, then
        an unclipped update): one ``adamw_update`` for each run of
        adjacent participating slots (the whole entry in a full round), on
        views of their rows, at the shared ``step`` the host passes.
        Dummies and absentees are untouched (their params and moments keep
        their bits); the entry's copy of the shared step advances.
        Returns the (K_loc,) gradient norms."""
        norms = client_norms(grads)
        clip = self.opt_cfg.clip_norm
        scale = torch.ones_like(norms) if clip is None else torch.clamp(
            clip / torch.clamp(norms, min=1e-9), max=1.0)
        for a, b in _live_spans(pm_loc):
            rows = lambda t: t[a:b]                  # noqa: E731
            adamw_update(tree_map(rows, params), tree_map(rows, grads),
                         {"mu": tree_map(rows, opt["mu"]),
                          "nu": tree_map(rows, opt["nu"]), "step": step},
                         self.opt_cfg, client_scale=scale[a:b])
        opt["step"] += 1
        return norms


def _live_spans(pm_loc) -> list:
    """(start, stop) of each run of adjacent nonzero slots of ``pm_loc``."""
    spans, start = [], None
    for i, m in enumerate([float(x) for x in pm_loc] + [0.0]):
        if m and start is None:
            start = i
        elif not m and start is not None:
            spans.append((start, i))
            start = None
    return spans


def make_sharded_dml_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                          n_clients: int, kl_weight: float = 1.0,
                          temperature: float = 1.0, remat: bool = True, *,
                          impl: str) -> ShardedDMLStep:
    """``make_dml_train_step`` sharded over a client mesh
    (``repro/core/distributed.py:262-354``).

    Each entry owns whole clients (round-robin spill for K > entries,
    ``stacking.client_layout``); private CE runs entry by entry, and the
    ONLY cross-entry tensor is the public-batch logits (K_loc, B_pub * S,
    V) of every entry, gathered once (``stacking.gather_clients``) and
    detached: the paper's communication frontier (``comm_bytes``'s
    ``dml_round`` counts these bytes sent and received).

    Two deliberate deltas from the unsharded step, as in JAX:
      - grad clipping is per client (``clip_norm`` applies to each
        client's own gradient, whose norm the metrics report);
      - the Eq.-2 term goes through ``ops.mutual_kl_pair``: live (K_loc,
        ...) against the gathered (K_pad, ...) with the rows of
        ``_pair_mask(K_pad, ...)`` at the entry's global ids, zero on each
        client's own column and on the padding slots (impl "cuda": the
        pair-KL kernels).

    Prefix-conditioned archs are refused.  Returns ``step(stacked_params,
    opt_state, tokens, public_tokens, part_mask=None)``; it updates the
    state IN PLACE, as the port's other steps do.
    """
    return ShardedDMLStep(cfg, opt_cfg, mesh, n_clients, kl_weight,
                          temperature, remat, impl)


# ---------------------------------------------------------------------------
# weight-sharing baselines on the client axis (in place)

def fedavg_sync(stacked_params: Params, part_mask=None) -> Params:
    """All-reduce(params)/K over the client axis (a vanilla FL round),
    averaged in fp32 and cast back, IN PLACE.  With ``part_mask`` (K,) 0/1
    only participants are averaged and only participants receive the
    aggregate (absentees are offline): the JAX package's
    ``weighted_average_weights`` then ``client_lerp``."""
    leaves = tree_leaves(stacked_params)
    device = leaves[0].device
    rows = w = None
    if part_mask is not None:
        rows = torch.as_tensor([c for c, m in enumerate(part_mask) if m],
                               dtype=torch.long, device=device)
        w = normalised_scores(part_mask, device)
    for p in leaves:
        avg = client_mean(p, w).to(p.dtype)
        if rows is None:
            p.copy_(avg.expand(p.shape))
        else:
            p[rows] = avg.expand((len(rows),) + tuple(p.shape[1:]))
    return stacked_params


def transformer_shallow_mask(cfg: ModelConfig, stacked_params: Params):
    """Float lerp-mask tree, each leaf (1, ...) broadcast against its param:
    embed/projector and the first half of the periods are 'shallow'
    (synced every round); the rest is 'deep'."""
    half = cfg.n_periods // 2

    def mask_like(names, p):
        if "periods" in names:
            per = (torch.arange(cfg.n_periods, device=p.device) < half)
            return per.float().reshape((1, cfg.n_periods)
                                       + (1,) * (p.dim() - 2))
        fill = 1.0 if ("embed" in names or "projector" in names) else 0.0
        return torch.full((1,) * p.dim(), fill, device=p.device)

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        return mask_like(names, tree)

    return walk(stacked_params, ())


def async_sync(stacked_params: Params, scores, shallow_mask,
               round_idx: int, delta: int = 3, min_round: int = 5,
               part_mask=None) -> Params:
    """Metric-weighted partial sync (the async baseline) on the client
    axis, IN PLACE: this round's scheduled group (``layer_schedule``) takes
    the ``scores``-weighted average, in fp32, cast back.  With
    ``part_mask`` (K,) 0/1 absentees keep their params (the JAX
    population's ``client_lerp`` after ``async_sync``)."""
    layer = layer_schedule(round_idx, delta, min_round)
    leaves = tree_leaves(stacked_params)
    w = normalised_scores(scores, leaves[0].device)
    pm = None if part_mask is None else torch.as_tensor(
        part_mask, dtype=torch.float32, device=leaves[0].device)
    for p, m in zip(leaves, tree_leaves(shallow_mask)):
        pf = p.float()
        avg = client_mean(p, w)
        lerp = m if layer == "shallow" else 1.0 - m
        if pm is not None:
            lerp = lerp * pm.reshape((-1,) + (1,) * (p.dim() - 1))
        p.copy_(pf * (1 - lerp) + avg * lerp)
    return stacked_params


# ---------------------------------------------------------------------------
# communication accounting (analytic)

def comm_bytes(cfg: ModelConfig, n_clients: int, public_tokens: int,
               bytes_per_el: int = 2) -> Dict[str, int]:
    n = cfg.param_count()
    return {
        "fedavg_round": 2 * n_clients * n * bytes_per_el,
        "dml_round": 2 * n_clients * public_tokens * cfg.vocab_size
        * bytes_per_el,
        "ratio": (n / max(public_tokens * cfg.vocab_size, 1)),
    }

