"""Deep mutual learning losses -- the paper's Eq. 1 and Eq. 2, dense
categorical half (``repro/core/mutual.py``).

    Loss_i    = ModelLoss_i + KLD_avg_i                       (Eq. 1)
    KLD_avg_i = 1/(K-1) * sum_{j != i} KL(P_i || P_j)         (Eq. 2)

Two gradient semantics:
  - ``mutual_kl_terms(live, fixed)``: the *federated* semantics -- each
    client descends its own loss with the received predictions held
    constant (``fixed`` detached).  Used inside train steps; ``impl``
    "cuda" runs the pair-KL kernel and its backward.
  - ``mutual_kl_eval``: forward-only, the sharing/eval readout.

The sparse half: clients publish only the top-k (index, log-prob) pairs of
their predictions (``topk_predictions``) and the receiver rebuilds each
distribution with a uniform tail over the other V - k entries
(``sparse_mutual_kl_loss``, ``sparse_kl_to_received``); impl "cuda" runs
the sparse-KL kernel and its backward.

The Bernoulli half is VisionNet's (the paper's case study): each client
shares one sigmoid probability per example, and Eq. 2 is the Bernoulli KL,
in plain PyTorch as in the JAX package.

The robust half (the Byzantine-robust strategies): a coordinate-wise
trimmed-mean or median consensus of the received predictions replaces the
Eq.-2 mean, and each client descends KL(P_i || consensus).  It has no
kernel in either package: plain PyTorch at every impl.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def _pair_mask(K: int, part_mask, device=None) -> torch.Tensor:
    """(K, K) fp32 pair weights for the Eq.-2 average under partial
    participation.

    ``part_mask`` is a (K,) 0/1 participation vector (None -> everyone).
    Row i is zeroed when client i sits the round out; column j is excluded
    from every average when client j shared nothing; the 1/(K-1)
    denominator shrinks to 1/(M-1) where M = number of participants.
    """
    eye = torch.eye(K, dtype=torch.float32, device=device)
    if part_mask is None:
        return (1.0 - eye) / max(K - 1, 1)
    m = torch.as_tensor(part_mask, dtype=torch.float32, device=device)
    pair = m[:, None] * m[None, :] * (1.0 - eye)
    denom = torch.clamp(torch.sum(m) - 1.0, min=1.0)
    return pair / denom


def mutual_kl_terms_vs(live_logits, fixed_logits, pair_w,
                       temperature: float = 1.0):
    """Rectangular Eq. 2: (Kl, B, V) live x (Kg, B, V) fixed -> (Kl, B),
    out[i, b] = sum_j pair_w[i, j] * KL(softmax(live_i) || softmax(fixed_j)),
    through the plain version."""
    return ref.mutual_kl_pair(live_logits, fixed_logits, pair_w,
                              temperature=temperature)


def mutual_kl_terms(live_logits, fixed_logits, temperature: float = 1.0,
                    part_mask=None, *, impl: str):
    """Eq. 2 with the j-side fixed.  (K, B, V) x (K, B, V) -> (K, B).

    out[i, b] = 1/(K-1) sum_{j != i} KL(softmax(live_i) || softmax(fixed_j)).
    Pass ``fixed_logits = live_logits.detach()`` for the federated gradient
    semantics.  ``part_mask`` (K,) 0/1 drops non-participants from both
    sides of the average.  ``impl`` "cuda" runs the pair-KL kernel with its
    backward; "ref" the plain version under autograd.
    """
    K = live_logits.shape[0]
    pair_w = _pair_mask(K, part_mask, live_logits.device)
    if impl != "ref":
        return ops.mutual_kl_pair(live_logits, fixed_logits, pair_w,
                                  temperature=temperature, impl=impl)
    return mutual_kl_terms_vs(live_logits, fixed_logits, pair_w,
                              temperature=temperature)


def mutual_kl_loss(all_logits, temperature: float = 1.0,
                   stop_grad_others: bool = True, part_mask=None, *,
                   impl: str):
    """Per-client mean Eq.-2 loss from a live stacked logits tensor.

    all_logits: (K, B, V) (flatten (B, S) upstream).  Returns (K,).
    """
    fixed = all_logits.detach() if stop_grad_others else all_logits
    terms = mutual_kl_terms(all_logits, fixed, temperature,
                            part_mask=part_mask, impl=impl)
    return torch.mean(terms, dim=-1)


def kl_to_received(live_logits, received_logits, temperature: float = 1.0,
                   *, impl: str):
    """Eq. 2 for ONE client against the predictions it received.

    live_logits: (B, V), differentiable.  received_logits: (J, B, V), the
    J other participants' shared logits (detached here).  Returns
    (B,) = 1/J * sum_j KL(softmax(live) || softmax(received_j)).  ``impl``
    "cuda" runs the rectangular pair-KL kernel and its backward (Kl = 1
    live row against the J received, weights 1/J; the JAX package runs
    this plain function on every impl); "ref" the plain graph.
    """
    J = received_logits.shape[0]
    if impl != "ref":
        pair_w = torch.full((1, J), 1.0 / max(J, 1), dtype=torch.float32,
                            device=live_logits.device)
        fixed = received_logits.detach().to(live_logits.dtype).contiguous()
        return ops.mutual_kl_pair(live_logits[None], fixed, pair_w,
                                  temperature=temperature, impl=impl)[0]
    rec = received_logits.detach().float()
    lp_live = torch.log_softmax(live_logits.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)
    lp_rec = torch.log_softmax(rec / temperature, dim=-1)       # (J,B,V)
    self_term = torch.sum(p_live * lp_live, dim=-1)             # (B,)
    cross = torch.einsum("bv,jbv->jb", p_live, lp_rec)          # (J,B)
    return self_term - torch.sum(cross, dim=0) / max(J, 1)


def mutual_kl_eval(all_logits, temperature: float = 1.0, *, impl: str):
    """Forward-only Eq. 2 (the sharing/benchmark readout): (K, B, V) ->
    (K, B); "cuda" runs the square case through the pair-KL forward."""
    return ops.mutual_kl(all_logits, temperature=temperature, impl=impl)


# ---------------------------------------------------------------------------
# sparse (top-k) prediction sharing: clients publish only (indices,
# log-probs) of their top-k tokens; the receiver treats the residual mass as
# uniform over the tail.  Cross-client bytes drop by V/(2k).

def _log_softmax(x):
    """``jax.nn.log_softmax``'s arithmetic (shifted - log sum exp(shifted)),
    so that which values tie is decided as in the JAX package."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1,
                                         keepdim=True))


def _topk_lax_order(x, k: int):
    """The k largest entries along the last axis in ``lax.top_k``'s order:
    values descending, ties toward the lower index.  Returns (values,
    indices (int64)).

    ``torch.topk`` promises no order among ties, which are common at the
    k-th place of bf16 logits over a wide vocabulary.  Its k-th value
    bounds the set: every entry above it is in, and where ties at it cross
    the k-th place, every entry at or above it is a candidate.  A stable
    sort of the candidates by index, then by value, gives the order.
    """
    vals, idx = torch.topk(x, k, dim=-1)
    n_ge = torch.sum(x >= vals[..., -1:], dim=-1)
    # the meta device (the dry-run) holds no values, so no ties: k wide
    wide = k if x.is_meta else int(n_ge.max())
    if wide > k:
        vals, idx = torch.topk(x, wide, dim=-1)
    idx, order = torch.sort(idx, dim=-1)
    vals = torch.gather(vals, -1, order)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals[..., :k], torch.gather(idx, -1, order)[..., :k]


def topk_predictions(logits, k: int, temperature: float = 1.0):
    """What a client publishes: (indices (..., k) int32, log-probs
    (..., k) fp32) of its top-k tokens, in ``lax.top_k``'s order."""
    logp = _log_softmax(logits.float() / temperature)
    vals, idx = _topk_lax_order(logp, k)
    return idx.to(torch.int32), vals


def sparse_mutual_kl_loss(live_logits, idx, logp_top,
                          temperature: float = 1.0, *, impl: str):
    """Eq. 2 against RECEIVED sparse predictions.

    live_logits: (K, B, V), local and differentiable.  idx, logp_top:
    (K, B, k), the received top-k sets (detached here).  Per pair

        KL(P_i || ~P_j) = -H(P_i) - c_j (1 - s_ij) - sum_t p_i[idx_j,t] logp_j[t]

    with s_ij = sum_t p_i[idx_j,t] and c_j = log(residual_j / (V - k)).
    Returns (K,) per-client means over B.  ``impl`` "cuda" runs the
    sparse-KL kernel with w = (1 - I) / (K - 1); "ref" the plain graph.
    """
    K, B, V = live_logits.shape
    k = idx.shape[-1]
    idx = idx.detach()
    logp_top = logp_top.detach().float()
    if impl != "ref":
        pair_w = _pair_mask(K, None, live_logits.device)
        terms = ops.sparse_mutual_kl(live_logits, idx, logp_top, pair_w,
                                     temperature=temperature, impl=impl)
        return torch.mean(terms, dim=-1)
    lp_live = torch.log_softmax(live_logits.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)                                  # (K,B,V)
    neg_h = torch.sum(p_live * lp_live, dim=-1)                  # (K,B)
    residual = torch.clamp(1.0 - torch.sum(torch.exp(logp_top), dim=-1),
                           1e-9, 1.0)                            # (K,B)
    c = torch.log(residual / max(V - k, 1))                      # (K,B)
    # one (K, B, k) gather per sender j: no (K, K, B, V) operand
    p_at = torch.stack([torch.gather(p_live, -1, idx[j].long()[None]
                                     .expand(K, B, k))
                        for j in range(K)], dim=1)               # (i,j,B,k)
    s = torch.sum(p_at, dim=-1)                                  # (i,j,B)
    cross_top = torch.sum(p_at * logp_top[None], dim=-1)         # (i,j,B)
    kl = neg_h[:, None, :] - c[None] * (1.0 - s) - cross_top
    mask = (1.0 - torch.eye(K, device=kl.device))[:, :, None]
    terms = torch.sum(kl * mask, dim=1) / max(K - 1, 1)          # (K,B)
    return torch.mean(terms, dim=-1)


def sparse_kl_to_received(live_logits, idx, logp_top,
                          temperature: float = 1.0, *, impl: str):
    """Eq. 2 for ONE client against RECEIVED sparse (top-k) predictions.

    live_logits: (B, V), local and differentiable.  idx, logp_top:
    (J, B, k), the J other participants' top-k sets (detached here).
    Returns (B,) = 1/J * sum_j KL_j, with the tail model of
    ``sparse_mutual_kl_loss``.  ``impl`` "cuda" runs the sparse-KL kernel
    with Kl = 1 and uniform 1/J weights.
    """
    J, B, k = idx.shape
    V = live_logits.shape[-1]
    idx = idx.detach()
    logp_top = logp_top.detach().float()
    if impl != "ref":
        pair_w = torch.full((1, J), 1.0 / max(J, 1), dtype=torch.float32,
                            device=live_logits.device)
        terms = ops.sparse_mutual_kl(live_logits[None], idx, logp_top,
                                     pair_w, temperature=temperature,
                                     impl=impl)
        return terms[0]
    lp_live = torch.log_softmax(live_logits.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)                                  # (B,V)
    neg_h = torch.sum(p_live * lp_live, dim=-1)                  # (B,)
    residual = torch.clamp(1.0 - torch.sum(torch.exp(logp_top), dim=-1),
                           1e-9, 1.0)                            # (J,B)
    c = torch.log(residual / max(V - k, 1))                      # (J,B)
    p_at = torch.gather(p_live[None].expand(J, B, V), -1, idx.long())
    s = torch.sum(p_at, dim=-1)                                  # (J,B)
    cross_top = torch.sum(p_at * logp_top, dim=-1)               # (J,B)
    kl = neg_h[None] - c * (1.0 - s) - cross_top                 # (J,B)
    return torch.sum(kl, dim=0) / max(J, 1)


def sparse_share_bytes(n_clients: int, n_examples: int, k: int) -> int:
    """Per-round traffic of top-k sharing (int32 idx + fp32 logp, up and
    down)."""
    return 2 * n_clients * n_examples * k * 8


# ---------------------------------------------------------------------------
# Byzantine-robust Eq.-2 combiners.  Plain DML averages the KL to every
# received prediction, so one confident-wrong payload pulls every honest
# client; the robust variants replace the mean with a coordinate-wise
# trimmed mean or median CONSENSUS TARGET over the received predictions and
# descend KL(P_i || target_i) instead.

_ABSENT = 1e9          # sort-key shift that pushes masked-out senders last


def _check_mode(mode: str) -> None:
    if mode not in ("trimmed", "median"):
        raise ValueError(f"robust mode must be 'trimmed' or 'median', "
                         f"got {mode!r}")


def robust_weighted_target(shared, recv_mask, mode: str, trim: int = 1):
    """Per-receiver robust consensus over received predictions.

    shared     (K, B) values shared by every client (Bernoulli probs, or
               any per-position scalar payload)
    recv_mask  (K_recv, K) 0/1 -- row i selects the senders receiver i
               aggregates over (participants minus self)
    mode       'trimmed' (drop the ``trim`` largest and smallest values
               per position) or 'median' (the mean of the two middle
               values when the count is even, as ``jnp.median``)
    Returns (K_recv, B) targets.  When a row's live sender count n
    satisfies n - 2 trim < 1 the trimmed mean falls back to the untrimmed
    masked mean (trim 0).
    """
    _check_mode(mode)
    shared = shared.float()
    m = torch.as_tensor(recv_mask, dtype=torch.float32, device=shared.device)
    vals = shared[None, :, :] + (1.0 - m)[:, :, None] * _ABSENT
    s = torch.sort(vals, dim=1).values                 # (Kr, K, B) ascending
    K = shared.shape[0]
    n = torch.sum(m, dim=1)[:, None, None]             # (Kr, 1, 1) live count
    ranks = torch.arange(K, dtype=torch.float32,
                         device=shared.device)[None, :, None]
    if mode == "median":
        lo = torch.floor((n - 1.0) / 2.0)
        hi = torch.floor(n / 2.0)
        w = 0.5 * ((ranks == lo).float() + (ranks == hi).float())
        return torch.sum(s * w, dim=1)
    t = torch.where(n - 2.0 * float(trim) >= 1.0,
                    torch.full_like(n, float(trim)), torch.zeros_like(n))
    w = ((ranks >= t) & (ranks < n - t)).float()
    return torch.sum(s * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                 min=1.0)


def robust_bernoulli_target(shared, part_mask, mode: str, trim: int = 1):
    """(K, B) shared Bernoulli probs -> (K, B) per-client robust targets
    (each client aggregates over the OTHER participants, as in Eq. 2),
    clipped to [1e-6, 1 - 1e-6]."""
    K = shared.shape[0]
    eye = torch.eye(K, dtype=torch.float32, device=shared.device)
    pm = torch.ones((K,), dtype=torch.float32, device=shared.device) \
        if part_mask is None else torch.as_tensor(
            part_mask, dtype=torch.float32, device=shared.device)
    recv = pm[None, :] * (1.0 - eye)
    tgt = robust_weighted_target(shared, recv, mode, trim)
    return torch.clamp(tgt, 1e-6, 1.0 - 1e-6)


# elements of fp32 probabilities a block of rows of
# ``robust_categorical_target`` holds (its sort adds values and int64
# indices): 64 Mi, 256 MB
_TARGET_BLOCK = 1 << 26


def robust_categorical_target(received_logits, mode: str, trim: int = 1):
    """(J, B, V) received logits -> (B, V) robust consensus distribution.

    Coordinate-wise trimmed mean or median over the J received softmax
    distributions (fp32), clipped to [1e-9, 1] and renormalised onto the
    simplex.  J - 2 trim < 1 falls back to the untrimmed mean.  The median
    of an even J is the mean of the ranks (J-1)//2 and J//2 (``jnp.median``;
    ``torch.median`` would take the lower one).  The target is per
    position, so it runs over blocks of rows: the sort's transient memory
    stays at a few times ``_TARGET_BLOCK`` elements.
    """
    _check_mode(mode)
    J, B, V = received_logits.shape
    t = trim if J - 2 * trim >= 1 else 0
    rows = max(1, _TARGET_BLOCK // max(J * V, 1))
    out = torch.empty((B, V), dtype=torch.float32,
                      device=received_logits.device)
    for b0 in range(0, B, rows):
        probs = torch.softmax(received_logits[:, b0:b0 + rows].float(),
                              dim=-1)                  # (J, rows, V)
        s = torch.sort(probs, dim=0).values
        del probs
        if mode == "median":
            lo, hi = (J - 1) // 2, J // 2
            tgt = s[lo] if lo == hi else 0.5 * (s[lo] + s[hi])
        else:
            tgt = torch.mean(s[t:J - t], dim=0)
        del s
        tgt = torch.clamp(tgt, 1e-9, 1.0)
        out[b0:b0 + rows] = tgt / torch.sum(tgt, dim=-1, keepdim=True)
        del tgt
    return out


def kl_to_robust_received(live_logits, received_logits, mode: str,
                          trim: int = 1, temperature: float = 1.0):
    """Robust Eq. 2 for ONE client: KL(P_live || robust consensus of the
    received predictions).  live (B, V) x received (J, B, V) -> (B,).
    The consensus target is data: computed without a graph."""
    with torch.no_grad():
        rec = received_logits.detach()
        if temperature != 1.0:
            rec = rec.float() / temperature
        log_tgt = torch.log(robust_categorical_target(rec, mode, trim))
        del rec
    lp_live = torch.log_softmax(live_logits.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)
    return torch.sum(p_live * (lp_live - log_tgt), dim=-1)


# ---------------------------------------------------------------------------
# Bernoulli case (VisionNet sigmoid head -- the paper's actual case study)

def _bernoulli_kl(pi, pj):
    return pi * torch.log(pi / pj) + (1 - pi) * torch.log((1 - pi) / (1 - pj))


def bernoulli_mutual_terms_vs(live_probs, fixed_probs, pair_w):
    """Rectangular Bernoulli Eq. 2: (Kl, B) live x (Kg, B) fixed -> (Kl, B)
    with explicit (Kl, Kg) pair weights; both sides clipped to
    [1e-6, 1 - 1e-6]."""
    pi = torch.clamp(live_probs.float(), 1e-6, 1 - 1e-6)[:, None, :]
    pj = torch.clamp(fixed_probs.float(), 1e-6, 1 - 1e-6)[None, :, :]
    return torch.sum(_bernoulli_kl(pi, pj) * pair_w[:, :, None], dim=1)


def bernoulli_mutual_terms(live_probs, fixed_probs, part_mask=None):
    """Eq. 2 with the j-side fixed, Bernoulli case: (K,B) x (K,B) -> (K,B).

    out[i, b] = 1/(K-1) sum_{j != i} KL(Bern(live_i) || Bern(fixed_j)).
    Callers wanting the federated gradient semantics detach the fixed side.
    ``part_mask`` (K,) 0/1 drops non-participants from both sides of the
    average.
    """
    K = live_probs.shape[0]
    return bernoulli_mutual_terms_vs(
        live_probs, fixed_probs,
        _pair_mask(K, part_mask, device=live_probs.device))


def bernoulli_mutual_loss(all_probs, stop_grad_others: bool = True,
                          fixed_probs=None, part_mask=None):
    """all_probs: (K, B) sigmoid outputs -> (K,) per-client Eq.-2 means.

    ``fixed_probs`` optionally supplies the received (j-side) predictions;
    it defaults to ``all_probs`` itself.
    """
    fixed = all_probs if fixed_probs is None else fixed_probs
    if stop_grad_others:
        fixed = fixed.detach()
    return torch.mean(bernoulli_mutual_terms(all_probs, fixed,
                                             part_mask=part_mask), dim=-1)


def bernoulli_mutual_eval(all_probs):
    return ref.bernoulli_mutual_kl(all_probs)


def bernoulli_kl_to_target(live_probs, target_probs):
    """Elementwise Bernoulli KL(live || target): (K, B) x (K, B) -> (K, B),
    the target held fixed (detached)."""
    pi = torch.clamp(live_probs.float(), 1e-6, 1 - 1e-6)
    pj = torch.clamp(target_probs.detach().float(), 1e-6, 1 - 1e-6)
    return _bernoulli_kl(pi, pj)
