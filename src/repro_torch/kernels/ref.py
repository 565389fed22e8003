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
import torch.nn.functional as F

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


def bernoulli_mutual_kl(probs) -> torch.Tensor:
    """Eq. 2 for the paper's sigmoid binary head.  probs: (K, B) in (0, 1),
    clipped to [1e-7, 1 - 1e-7].  Returns (K, B) fp32."""
    K = probs.shape[0]
    p = torch.clamp(probs.float(), 1e-7, 1 - 1e-7)
    pi = p[:, None, :]                                   # (i,1,B)
    pj = p[None, :, :]                                   # (1,j,B)
    kl = pi * torch.log(pi / pj) + (1 - pi) * torch.log((1 - pi) / (1 - pj))
    mask = (1.0 - torch.eye(K, device=probs.device))[:, :, None]
    return torch.sum(kl * mask, dim=1) / max(K - 1, 1)


def sparse_kl_pair(live, idx, logp_top, pair_w, temperature: float = 1.0
                   ) -> torch.Tensor:
    """Pair-weighted Eq. 2 against RECEIVED sparse (top-k) predictions
    (``repro/kernels/ref.py:150``).

    live: (Kl, B, V), the differentiable side.  idx, logp_top: (J, B, k),
    the shared top-k sets.  pair_w: (Kl, J) weights.  Returns (Kl, B) fp32:

        out[i, b] = sum_j w[i, j] * KL(P_i(b) || ~Q_j(b))

    with ~Q_j = the top-k mass of Q_j + a uniform tail over the V - k
    residual (the SparseDML reconstruction), i.e. per pair

        KL_ij = -H(P_i) - c_j (1 - s_ij) - sum_t p_i[idx_j,t] logp_j[t]

    where s_ij = sum_t p_i[idx_j,t] and c_j = log(residual_j / (V - k)).
    """
    Kl, B, V = live.shape
    J, _, k = idx.shape
    lp_live = torch.log_softmax(live.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)                                  # (Kl,B,V)
    neg_h = torch.sum(p_live * lp_live, dim=-1)                  # (Kl,B)
    logp = logp_top.float()                                      # (J,B,k)
    residual = torch.clamp(1.0 - torch.sum(torch.exp(logp), dim=-1),
                           1e-9, 1.0)
    c = torch.log(residual / max(V - k, 1))                      # (J,B)
    # p_at[i, j, b, t] = p_live[i, b, idx[j, b, t]]
    p_at = torch.gather(p_live[:, None].expand(Kl, J, B, V), -1,
                        idx.long()[None].expand(Kl, J, B, k))
    s = torch.sum(p_at, dim=-1)                                  # (Kl,J,B)
    cross = torch.sum(p_at * logp[None], dim=-1)                 # (Kl,J,B)
    kl = neg_h[:, None, :] - c[None] * (1.0 - s) - cross
    return torch.einsum("ij,ijb->ib", pair_w.float(), kl)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) chunked scan

def ssd(x, dt, A, B_mat, C_mat, *, chunk: int = 256,
        initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan oracle (``repro/kernels/ref.py:201-260``).

    x:     (B, S, H, P)   pre-gated inputs
    dt:    (B, S, H)      positive step sizes (softplus already applied)
    A:     (H,)           negative decay rates
    B_mat: (B, S, G, N)   input projections (G groups, H % G == 0)
    C_mat: (B, S, G, N)   output projections
    Returns (y (B,S,H,P) in x.dtype, final_state (B,H,P,N) fp32); the
    arithmetic is fp32 and the gradients come from autograd.
    """
    Bb, S, H, Pd = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    pad = (-S) % chunk
    if pad:
        zf = lambda a: F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])  # noqa
        x, dt, B_mat, C_mat = map(zf, (x, dt, B_mat, C_mat))
    Sp = S + pad
    nc = Sp // chunk
    xc = x.reshape(Bb, nc, chunk, H, Pd).float()
    dtc = dt.reshape(Bb, nc, chunk, H).float()
    Bc = B_mat.reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, 3).float()
    Cc = C_mat.reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, 3).float()
    Af = A.float()

    dA = dtc * Af                                        # (B,nc,L,H) <= 0
    cs = torch.cumsum(dA, dim=2)                         # within-chunk cumsum

    state = initial_state
    if state is None:
        state = torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                            device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc_, dtc_, Bc_, Cc_, cs_ = (t[:, c] for t in (xc, dtc, Bc, Cc, cs))
        # intra-chunk: M[t,s] = C_t.B_s * exp(cs_t - cs_s) * dt_s,  s <= t
        scores = torch.einsum("blhn,bshn->bhls", Cc_, Bc_)
        # the exponent is <= 0 only on the causal (t >= s) triangle; clamp
        # the masked half before exp so inf * 0 never produces NaN
        expo = cs_[:, :, None, :] - cs_[:, None, :, :]             # (B,t,s,H)
        decay = torch.exp(torch.minimum(expo, zero)).permute(0, 3, 1, 2)
        w = scores * decay * dtc_.permute(0, 2, 1)[:, :, None, :] * tri
        y_intra = torch.einsum("bhls,bshp->blhp", w, xc_)
        # inter-chunk: y += exp(cs_t) * C_t . state
        y_inter = torch.einsum("blhn,bhpn->blhp", Cc_, state) \
            * torch.exp(cs_)[..., None]
        # state update
        tail = torch.exp(cs_[:, -1:, :] - cs_) * dtc_                # (B,L,H)
        state = torch.exp(cs_[:, -1, :])[:, :, None, None] * state + \
            torch.einsum("blhn,blhp,blh->bhpn", Bc_, xc_, tail)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bb, Sp, H, Pd)[:, :S]
    return y.to(x.dtype), state
