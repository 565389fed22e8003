"""Step helpers shared by the serving engine and the CLI."""
from __future__ import annotations

import torch


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
