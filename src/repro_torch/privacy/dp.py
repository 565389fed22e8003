"""Clip + Gaussian-noise transforms for shared prediction payloads
(``repro/privacy/dp.py``) -- what DP-DML applies BEFORE predictions cross
client boundaries.

The DP unit is one client's whole per-epoch payload: the (positions,)
Bernoulli probability vector (VisionClients) or the (positions, V) logit
tensor (HeteroClients), flattened and L2-clipped to ``clip`` so the
Gaussian mechanism's sensitivity is bounded by construction, then noised
with std ``clip * noise_multiplier``.  The accountant
(``privacy.accountant``) charges one Gaussian release per client per
mutual epoch for exactly this transform.

The noise is an argument: the standard-normal draw itself, fp32, of the
payload's shape.  ``gaussian`` is the port's one source of it -- a
``torch.Generator`` on the payload's device seeded from a (2,) uint32 key
(the JAX package's raw PRNG key words).  The distribution is the JAX
package's; the bits are the port's own.  A ``noise_multiplier`` of 0
returns the payload bitwise unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class DPSpec:
    """One round's DP parameters, handed by ``DPDML`` to the population.

    clip              L2 bound on each client's flattened payload
    noise_multiplier  noise std in units of ``clip``
    keys              (mutual_epochs, 2) uint32 keys, one per epoch; the
                      epoch's draw covers the whole stacked payload, so
                      every client's release draws independent noise
    """
    clip: float
    noise_multiplier: float
    keys: Any = None


def gaussian(key_words, shape, device) -> torch.Tensor:
    """Standard-normal fp32 draws of ``shape`` on ``device`` from a
    ``torch.Generator`` seeded from the two uint32 words of ``key_words``
    (mixed by ``np.random.SeedSequence`` into one 64-bit seed whose low
    half, all the CPU generator keeps, depends on both words).  The one
    source of DP noise in the port."""
    words = [int(w) for w in np.asarray(key_words, np.uint32).reshape(2)]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def clip_payload(payload: torch.Tensor, clip: float) -> torch.Tensor:
    """L2-clip each leading-axis slice of ``payload`` (one slice = one
    client's release), flattening the rest: ``x * min(1, clip / ||x||)``.
    One slice at a time: its norm accumulates in fp32 and it is scaled in
    fp32, then cast back to the payload's dtype."""
    flat = payload.reshape(payload.shape[0], -1)
    out = torch.empty_like(flat)
    for i, row in enumerate(flat):
        norm = torch.linalg.vector_norm(row, dtype=torch.float32)
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        out[i] = row.float() * scale
    return out.reshape(payload.shape)


def dp_noise_payload(payload: torch.Tensor, clip: float,
                     noise_multiplier: float,
                     noise: Optional[torch.Tensor],
                     center: Optional[float] = None) -> torch.Tensor:
    """Clip + Gaussian-noise one stacked payload (K releases at once).

    payload: (K, ...) -- the leading axis is the releasing client.
    ``noise``: the fp32 standard-normal draw of ``payload.shape`` (unused,
    and may be None, when ``noise_multiplier <= 0``).  ``center`` (e.g.
    0.5 for Bernoulli probabilities) is subtracted before clipping and
    added back after noising.  The noise, scaled to std ``clip *
    noise_multiplier``, is cast to the payload's dtype before it is added,
    one client's slice at a time (a card-size stack holds 1.24 GB of bf16
    against 2.5 GB of fp32 noise).  ``noise_multiplier <= 0`` returns
    ``payload`` itself.
    """
    if noise_multiplier <= 0:
        return payload
    x = payload if center is None else payload - center
    noised = clip_payload(x, clip)
    std = noise_multiplier * clip
    for i in range(noised.shape[0]):
        noised[i] += (noise[i] * std).to(payload.dtype)
    if center is not None:
        noised += center
    return noised


def dp_probs_payload(probs: torch.Tensor, clip: float,
                     noise_multiplier: float,
                     noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Bernoulli-probability payloads: center at 0.5, clip + noise, clamp
    back into [1e-4, 1 - 1e-4] so downstream KL terms stay finite.
    ``noise_multiplier <= 0`` returns ``probs`` itself."""
    if noise_multiplier <= 0:
        return probs
    out = dp_noise_payload(probs, clip, noise_multiplier, noise, center=0.5)
    return torch.clamp(out, 1e-4, 1.0 - 1e-4)
