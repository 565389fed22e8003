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

The sparse (top-k), robust and Bernoulli halves come with their slices.
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


def kl_to_received(live_logits, received_logits, temperature: float = 1.0):
    """Eq. 2 for ONE client against the predictions it received.

    live_logits: (B, V), differentiable.  received_logits: (J, B, V), the
    J other participants' shared logits (detached here).  Returns
    (B,) = 1/J * sum_j KL(softmax(live) || softmax(received_j)).
    """
    rec = received_logits.detach().float()
    lp_live = torch.log_softmax(live_logits.float() / temperature, dim=-1)
    p_live = torch.exp(lp_live)
    lp_rec = torch.log_softmax(rec / temperature, dim=-1)       # (J,B,V)
    self_term = torch.sum(p_live * lp_live, dim=-1)             # (B,)
    cross = torch.einsum("bv,jbv->jb", p_live, lp_rec)          # (J,B)
    J = received_logits.shape[0]
    return self_term - torch.sum(cross, dim=0) / max(J, 1)


def mutual_kl_eval(all_logits, temperature: float = 1.0, *, impl: str):
    """Forward-only Eq. 2 (the sharing/benchmark readout): (K, B, V) ->
    (K, B); "cuda" runs the square case through the pair-KL forward."""
    return ops.mutual_kl(all_logits, temperature=temperature, impl=impl)
