"""Ensemble inference over a trained DML client population.

The paper's deployable artifact is the POPULATION: K mutually-distilled
clients whose predictions were the only thing that ever crossed client
boundaries during training.  Two ways to serve them:

  - ``average``: every decode step runs all K clients (one batched call
    over the stacked client axis) and samples from the MEAN of their
    logits -- the serving-time analogue of the Eq.-2 consensus target.
  - ``route``: pick ONE client per request, the one with the lowest
    teacher-forced cross-entropy on the prompt (each client's loss profile
    reflects its own data domain); the request's slot is bound to it.

``load_serving_params`` reads a checkpoint written by the JAX package
(``Federation.save_state`` of the LM population, the slim
``export_for_serving`` artifact, or a single-model ``launch.train --save``
file) into (config, stacked params, K).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import checkpoint
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map


def prompt_ce_clients(sparams, cfg: ModelConfig, tokens, prefix=None, *,
                      impl: str) -> torch.Tensor:
    """Per-SEQUENCE next-token CE of prompts (B, S), behind ``prefix``
    (B, P, pd) for a prefix-token arch, under each of K clients -> (K, B):
    same label alignment as the JAX ``tfm.loss_fn`` (with a prefix the
    logits at P-1 .. P+S-2 predict tokens[0:]), kept per row so each
    request routes independently."""
    x, _ = tfm.forward_hidden_clients(sparams, cfg, tokens, prefix,
                                      remat=False, impl=impl)
    logits = tfm.loss_logits(sparams, cfg, x)
    pred = logits[:, :, :-1]
    labels = tokens if cfg.prefix_tokens else tokens[:, 1:]
    logp = torch.log_softmax(pred.float(), dim=-1)
    idx = labels.long().expand(logp.shape[0], *labels.shape)[..., None]
    return -logp.gather(-1, idx)[..., 0].mean(dim=-1)


def prompt_ce(params, cfg: ModelConfig, tokens, prefix=None, *, impl: str):
    """One model: per-sequence prompt CE (B, S) -> (B,)."""
    return prompt_ce_clients(tree_map(lambda t: t[None], params), cfg,
                             tokens, prefix, impl=impl)[0]


def make_router(cfg: ModelConfig, impl: str):
    """Routing program: (stacked params, prompts (B, S)[, prefix (B, P,
    pd)]) -> (client_idx (B,), ce (K, B)).  One call per admission
    batch."""
    def route(stacked_params, prompts, prefix=None):
        ce = prompt_ce_clients(stacked_params, cfg, prompts, prefix,
                               impl=impl)
        return torch.argmin(ce, dim=0), ce
    return route


def combine_logits(logits: torch.Tensor, mode: str,
                   client_idx: Optional[torch.Tensor] = None):
    """(K, B, V) per-client logits -> (B, V) served logits: the mean over
    clients (``average``) or each row's bound client (``route``)."""
    if mode == "average":
        return logits.mean(dim=0)
    if mode == "route":
        return logits[client_idx, torch.arange(logits.shape[1],
                                               device=logits.device)]
    raise ValueError(f"unknown ensemble mode {mode!r}")


# ---------------------------------------------------------------------------
# checkpoint -> serving

def load_serving_params(path: str, *, device) -> Tuple[ModelConfig, dict,
                                                        int]:
    """Read a JAX-written training checkpoint into serving shape on
    ``device``.  Returns ``(cfg, params, n_clients)``; params carry a
    leading stacked-client axis (a single-model file becomes a stack of 1).
    As in the JAX package, a checkpoint carries the REDUCED config of its
    arch.  Hetero populations (one tree per arch) are rejected."""
    state, meta = checkpoint.restore(path)
    engine = meta.get("engine")
    if engine not in (None, "lm"):
        raise ValueError(
            f"checkpoint engine {engine!r} is not servable: the serving "
            "engine needs same-arch clients stacked on a leading axis "
            "(the LM population / export_for_serving artifacts)")
    arch = meta.get("arch")
    if arch not in ARCH_IDS:
        raise ValueError(f"checkpoint arch {arch!r} not in {ARCH_IDS}")
    cfg = get_reduced(arch)
    if isinstance(state, dict) and "client_params" in state:
        params = state["client_params"]
        n_clients = int(meta.get("n_clients", 0) or
                        tree_leaves(params)[0].shape[0])
    else:                       # single-model launch.train --save file
        if not isinstance(state, dict) or "embed" not in state:
            raise ValueError(f"unrecognised checkpoint schema in {path!r}")
        params, n_clients = tree_map(lambda t: t[None], state), 1
    return cfg, tree_map(lambda t: t.to(device), params), n_clients
