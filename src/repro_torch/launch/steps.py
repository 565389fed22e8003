"""Step builders of the single-model path and the serving loop
(``repro/launch/steps.py``): the train step, prefill and decode, the
multi-step decode, token sampling and the decode-window policy.

Each builder returns a plain function over one model's params (no client
axis).  ``impl`` is the kernel impl the caller resolved
(``ops.resolve_impl``): it runs the attention and SSD forwards and
backwards; decode always runs the plain attention against the cache, as in
the JAX package.  The JAX ``unroll`` flag has no meaning here: the port
always walks the layers in a Python loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.distributed import value_and_grad
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = True, window: Optional[int] = None,
                    ce_impl: str = "dense", slot_remat: bool = False, *,
                    impl: str):
    """Single-model (non-federated) train step: CE (+ MoE aux) + AdamW.
    ``step(params, opt_state, tokens (B, S), prefix=None)`` updates params
    and moments IN PLACE and returns (params, opt_state, metrics):
    ``loss_fn``'s {"ce", "load_balance", "router_z"} and the optimiser's
    {"grad_norm", "lr"}."""
    def step(params, opt_state, tokens, prefix=None):
        _, metrics, grads = value_and_grad(
            tfm.loss_fn, params, cfg, tokens, prefix, window=window,
            remat=remat, ce_impl=ce_impl, slot_remat=slot_remat, impl=impl)
        params2, opt2, om = adamw_update(params, grads, opt_state, opt_cfg)
        return params2, opt2, {**{k: v.detach() for k, v in metrics.items()},
                               **om}
    return step


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      window: Optional[int] = None, *, impl: str):
    """``step(params, tokens (B, S), prefix=None)`` -> (last-token logits
    (B, V), cache)."""
    @torch.no_grad()
    def step(params, tokens, prefix=None):
        return tfm.prefill(params, cfg, tokens, prefix, max_seq=max_seq,
                           window=window, impl=impl)
    return step


def make_decode_step(cfg: ModelConfig, window: Optional[int] = None):
    """``step(params, token (B, 1), cache, pos)`` -> (logits (B, V), cache);
    the cache is updated in place."""
    @torch.no_grad()
    def step(params, token, cache, pos):
        return tfm.decode_step(params, cfg, token, cache, pos, window=window)
    return step


def sample_token(logits, generator: torch.Generator,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """One sampled token id per row of ``logits`` (B, V), as int64.

    temperature <= 0 is EXACT greedy (argmax; the first index among ties,
    like ``jnp.argmax``) and draws nothing; otherwise temperature-scaled
    categorical sampling from ``generator``, optionally restricted to the
    top-k logits (the threshold keeps ties: ``scaled >= kth``).
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_multistep_decode(cfg: ModelConfig, gen_len: int,
                          window: Optional[int] = None,
                          temperature: float = 0.0, top_k: int = 0):
    """``gen_len`` decode steps, a Python loop of ``decode_step`` and
    ``sample_token`` (the JAX package's ``lax.scan``; one CUDA graph of it
    is later work).

    The returned step takes ``(params, token, cache, pos, generator)``
    where ``token`` (B, 1) is the next token to EMIT (after prefill,
    sample the prefill logits), ``pos`` an int or a (B,) tensor of the
    positions of that emission, and ``generator`` the sampling state
    (drawn from only when temperature > 0).

    Returns ``(tokens (B, gen_len), logits (B, gen_len, V), cache,
    next_token (B, 1), next_pos, generator)``: feeding the last three into
    the next call continues exactly where one longer call would have.
    ``logits[:, t]`` is the distribution the (t+1)-th emission was sampled
    from, aligned with the teacher-forced forward at the same positions.
    """
    @torch.no_grad()
    def step(params, token, cache, pos, generator):
        toks, logits = [], []
        for _ in range(gen_len):
            lg, cache = tfm.decode_step(params, cfg, token, cache, pos,
                                        window=window)
            toks.append(token[:, 0])
            logits.append(lg)
            token = sample_token(lg, generator, temperature, top_k)[:, None]
            pos = pos + 1
        return (torch.stack(toks, dim=1), torch.stack(logits, dim=1), cache,
                token, pos, generator)
    return step


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Long-context policy: dense archs use the sliding-window variant at
    500k; native sub-quadratic archs keep their own setting."""
    if shape.name == "long_500k" and \
            cfg.long_context_variant == "sliding_window":
        return cfg.long_context_window
    return cfg.sliding_window
