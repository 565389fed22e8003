"""Meta-tensor stand-ins for every model input -- the dry-run contract (the
port of ``repro/launch/specs.py``).

Each function returns tensors on ``torch.device("meta")``: the shapes and
dtypes of the step function's arguments, built by the port's own
``tfm.init_model``, ``adamw_init`` and ``tfm.init_cache``, with no storage
and nothing drawn.  Modality frontends are stubs: VLM/audio archs get a
precomputed embedding prefix of the configured size, with the token count
reduced so that the total sequence length equals the assigned shape.

The JAX module also returns each tree's logical axes (the ``*_logical_axes``
helpers): they name the TPU mesh's axes and are not ported, so these
functions return the tensors alone.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.steps import decode_window
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init

META = torch.device("meta")


def token_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text-token count so prefix + tokens == shape.seq_len."""
    if shape.kind == "decode":
        return 1
    if shape.seq_len <= cfg.prefix_tokens:
        raise ValueError(f"{cfg.name}: {shape.name}'s {shape.seq_len} "
                         f"positions leave no room past the "
                         f"{cfg.prefix_tokens}-position prefix")
    return shape.seq_len - cfg.prefix_tokens


def batch_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 n_clients: int = 0) -> Dict[str, Any]:
    """The data inputs of a train/prefill step: {"tokens" (B, S) int32,
    "prefix" (B, P, pd) for a prefix-token arch}.  n_clients > 0 splits the
    global batch over a leading client axis (DML mode)."""
    B = shape.global_batch
    S = token_len(cfg, shape)
    lead = ()
    if n_clients:
        if B % n_clients:
            raise ValueError(f"global batch {B} does not split over "
                             f"{n_clients} clients")
        lead, B = (n_clients,), B // n_clients
    specs = {"tokens": torch.empty(lead + (B, S), dtype=torch.int32,
                                   device=META)}
    if cfg.prefix_tokens:
        specs["prefix"] = torch.empty(
            lead + (B, cfg.prefix_tokens, cfg.prefix_dim),
            dtype=cfg.cdtype(), device=META)
    return specs


def public_inputs(cfg: ModelConfig, shape: ShapeConfig,
                  public_batch: int) -> Dict[str, Any]:
    """The public mutual-learning batch, shared by all clients:
    {"public_tokens" (B_pub, S), "public_prefix" (B_pub, P, pd)}."""
    S = token_len(cfg, shape)
    specs = {"public_tokens": torch.empty((public_batch, S),
                                          dtype=torch.int32, device=META)}
    if cfg.prefix_tokens:
        specs["public_prefix"] = torch.empty(
            (public_batch, cfg.prefix_tokens, cfg.prefix_dim),
            dtype=cfg.cdtype(), device=META)
    return specs


def model_state_specs(cfg: ModelConfig, n_clients: int = 0):
    """The param tree on the meta device (``n_clients`` > 0 stacks a client
    axis, as ``distributed.stacked_init`` does)."""
    return tfm.init_model(0, cfg, n_clients=n_clients, device=META)


def opt_state_specs(param_specs):
    """AdamW state over ``param_specs``: fp32 moments and the 0-d int32
    step, on the meta device."""
    return adamw_init(param_specs)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of one model for ``shape``, at the shape's window
    (``decode_window``)."""
    return tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          window=decode_window(cfg, shape), device=META)
