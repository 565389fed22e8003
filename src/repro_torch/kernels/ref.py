"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth: the CPU path runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  Each
mirrors its counterpart in the JAX package's ``kernels/ref.py``; their
gradients come from autograd, and autograd of ``attention_lse`` is the
flash backward's plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _masked_logits(q, k, causal, window, positions_q, positions_k):
    """fp32 scores (B, Hkv, S, G, T), masked entries set to NEG_INF."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qf = q.reshape(B, S, Hkv, Hq // Hkv, hd).float()
    logits = torch.einsum("bskgh,btkh->bksgt", qf, k.float()) * (hd ** -0.5)
    if positions_q is None:
        positions_q = torch.arange(S, device=q.device).expand(B, S)
    if positions_k is None:
        positions_k = torch.arange(T, device=q.device).expand(B, T)
    pq = positions_q[:, None, :, None, None]            # (B,1,S,1,1)
    pk = positions_k[:, None, None, None, :]            # (B,1,1,1,T)
    mask = pk >= 0
    if causal:
        mask = mask & (pk <= pq)
    if window is not None:
        mask = mask & (pq - pk < window)
    return torch.where(mask, logits, NEG_INF)


def _weighted_values(logits, q, v):
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bksgt,btkh->bskgh", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              positions_q=None, positions_k=None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd); Hq % Hkv == 0.
    positions_*: optional absolute positions (B, S)/(B, T); entries < 0 in
    positions_k mark invalid (unwritten) cache slots.  Without positions,
    the index within the array is the position (self-attention).
    Returns (B, S, Hq, hd) in q.dtype; softmax in fp32.
    """
    logits = _masked_logits(q, k, causal, window, positions_q, positions_k)
    return _weighted_values(logits, q, v)


def attention_lse(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention as ``attention``, plus the per-row logsumexp
    (B, Hq, S) fp32: the flash kernel's two outputs."""
    logits = _masked_logits(q, k, causal, window, None, None)
    B, S, Hq, _ = q.shape
    lse = torch.logsumexp(logits, dim=-1)               # (B,Hkv,S,G)
    return (_weighted_values(logits, q, v),
            lse.permute(0, 1, 3, 2).reshape(B, Hq, S))


# ---------------------------------------------------------------------------
# mutual-learning KL (the paper's Eq. 2 at vocabulary scale)

def mutual_kl(logits, temperature: float = 1.0) -> torch.Tensor:
    """Average pairwise KL of each client against the rest.

    logits: (K, B, V).  Returns (K, B) fp32:
        out[i, b] = 1/(K-1) * sum_{j != i} KL(P_i(b) || P_j(b))
    with P = softmax(logits / T).
    """
    K = logits.shape[0]
    logp = torch.log_softmax(logits.float() / temperature, dim=-1)
    p = torch.exp(logp)
    self_term = torch.sum(p * logp, dim=-1)                   # (K,B)
    cross = torch.einsum("ibv,jbv->ijb", p, logp)             # (i,j,B)
    kl = self_term[:, None, :] - cross                        # KL(i||j)
    mask = (1.0 - torch.eye(K, device=logits.device))[:, :, None]
    return torch.sum(kl * mask, dim=1) / max(K - 1, 1)


def mutual_kl_pair(live, fixed, pair_w, temperature: float = 1.0
                   ) -> torch.Tensor:
    """Pair-weighted rectangular Eq. 2.

    live: (Kl, B, V), the differentiable side.  fixed: (Kg, B, V).
    pair_w: (Kl, Kg) weights (e.g. the masked 1/(M-1) average).  Returns
    (Kl, B) fp32: out[i, b] = sum_j pair_w[i, j] * KL(P_i(b) || Q_j(b)).
    ``mutual_kl(x) == mutual_kl_pair(x, x, (1 - I) / (K - 1))``.
    """
    lp_live = torch.log_softmax(live.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)
    lp_fixed = torch.log_softmax(fixed.float() / temperature, dim=-1)
    self_term = torch.sum(p_live * lp_live, dim=-1)              # (Kl,B)
    cross = torch.einsum("ibv,jbv->ijb", p_live, lp_fixed)       # (i,j,B)
    kl = self_term[:, None, :] - cross
    return torch.sum(kl * pair_w.float()[:, :, None], dim=1)
