"""Model stack of the port (layers, attention, the decoder backbone, the
paper's VisionNet) and the per-client model registry for heterogeneous
federation (``repro/models/__init__.py``).

``get_client_model`` wraps a model behind one small interface so that
``core.populations.hetero.HeteroClients`` can federate clients whose
trees do not even match: every client exposes init / private loss /
public CE and logits / shared logits, and only the shared (N_pub, V)
logits ever cross a client boundary.

Two modalities ("kind"):
  - 'lm':     token streams; V = vocab_size.  Families dense / ssm / moe /
              hybrid, one model through the K = 1 entry points of
              ``models.transformer``.
  - 'vision': the paper's VisionNet, a one-client stack through
              ``models.visionnet``; the Bernoulli head is lifted to
              2-class logits [log(1-p), log p] so the categorical Eq.-2
              machinery applies unchanged (softmax == [1-p, p]).

Every callable takes the population's kernel ``impl`` (VisionNet runs no
kernel of this repo and ignores it) and a dropout ``torch.Generator`` or
None where the JAX package takes a PRNG key; the draws are the port's own.
``get_client_model`` takes an arch id, as the JAX package does, or a
config object (``ModelConfig`` / ``VisionNetConfig``), whose ``name`` is
then the arch id: the way to cut a model's depth at full width.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.visionnet import VisionNetConfig
from repro_torch.core.stacking import expand_stack
from repro_torch.models import transformer, visionnet


class ClientModel(NamedTuple):
    """One federated client's model, behind the modality-uniform interface.

    The loss callables take gathered tensors (inputs, labels); ``labels``
    is ignored by 'lm' clients (next-token targets come from the stream).
    """
    arch: str                     # registry id ('qwen3-4b', 'visionnet', ...)
    family: str                   # dense | ssm | moe | hybrid | vision
    kind: str                     # 'lm' | 'vision'
    cfg: Any
    init: Callable                # (seed, device) -> params
    private_loss: Callable        # (params, inputs, labels, gen, *, impl)
    #                                 -> 0-d loss
    public_ce_and_logits: Callable  # (params, inputs, labels, gen, *, impl)
    #                                   -> (ce, logits (N_pub, V))
    share_logits: Callable        # (params, inputs, *, impl) -> (N_pub, V)
    n_classes: int                # V of the shared prediction space


def _lm_client(arch: str, cfg: ModelConfig) -> ClientModel:
    V = cfg.vocab_size

    def init(seed: int, device):
        return transformer.init_model(seed, cfg, device=device)

    def private_loss(params, tokens, labels, gen, *, impl: str):
        del labels, gen                      # targets are the shifted stream
        loss, _ = transformer.loss_fn(params, cfg, tokens, impl=impl)
        return loss

    def public_ce_and_logits(params, tokens, labels, gen, *, impl: str):
        del labels, gen
        logits = transformer.forward(params, cfg, tokens, impl=impl)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ce = -torch.mean(torch.gather(logp, -1, tokens[:, 1:, None].long()))
        return ce, logits.reshape(-1, V)

    @torch.no_grad()
    def share_logits(params, tokens, *, impl: str):
        return transformer.forward(params, cfg, tokens,
                                   impl=impl).reshape(-1, V)

    return ClientModel(arch, cfg.family, "lm", cfg, init, private_loss,
                       public_ce_and_logits, share_logits, V)


def _bern_to_logits(p):
    """(B,) sigmoid prob -> (B, 2) fp32 logits with softmax exactly
    [1-p, p]."""
    p = torch.clamp(p.float(), 1e-6, 1 - 1e-6)
    return torch.stack([torch.log1p(-p), torch.log(p)], dim=-1)


def _vision_client(arch: str, cfg: VisionNetConfig) -> ClientModel:
    def init(seed: int, device):
        return visionnet.init_visionnet(seed, cfg, device)

    def probs(params, images, gen, train: bool):
        return visionnet.visionnet_forward(expand_stack(params), cfg, images,
                                           train=train, generator=gen)[0]

    def private_loss(params, images, labels, gen, *, impl: str):
        return visionnet.bce_loss(probs(params, images, gen, True), labels)

    def public_ce_and_logits(params, images, labels, gen, *, impl: str):
        p = probs(params, images, gen, True)
        return visionnet.bce_loss(p, labels), _bern_to_logits(p)

    @torch.no_grad()
    def share_logits(params, images, *, impl: str):
        return _bern_to_logits(probs(params, images, None, False))

    return ClientModel(arch, "vision", "vision", cfg, init, private_loss,
                       public_ce_and_logits, share_logits, 2)


def get_client_model(arch: Union[str, ModelConfig, VisionNetConfig],
                     reduced: bool = True) -> ClientModel:
    """Resolve an arch id (its reduced or full config) or a config object
    to its family-specific client interface.  Allocates nothing."""
    if isinstance(arch, VisionNetConfig):
        return _vision_client(arch.name, arch)
    if arch == "visionnet":
        from repro_torch.configs import visionnet as vn_cfg
        return _vision_client(arch, vn_cfg.reduced() if reduced
                              else vn_cfg.CONFIG)
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        from repro_torch.configs import get_config, get_reduced
        cfg = get_reduced(arch) if reduced else get_config(arch)
    if cfg.prefix_tokens:
        raise ValueError(
            f"{cfg.name}: modality-frontend archs (prefix_tokens > 0) are "
            "not supported as heterogeneous clients -- the public set is a "
            "plain token stream")
    return _lm_client(cfg.name, cfg)
