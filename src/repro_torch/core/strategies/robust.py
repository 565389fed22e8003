"""Byzantine-robust DML variants (``repro/core/strategies/robust.py``) --
Eq. 2 with the mean over received predictions replaced by a robust
consensus.

Plain DML descends the AVERAGE KL to every received prediction, so a
single colluding or sign-flipped payload shifts every honest client's
Eq.-1 gradient.  These strategies aggregate the received predictions
into a coordinate-wise trimmed-mean or median consensus target first
(``mutual.robust_bernoulli_target`` / ``robust_categorical_target``) and
descend ``KL(P_i || target_i)``: up to f = trim poisoned participants per
round contribute nothing to any position they try to drag.

Degenerate participation is deterministic: M < 2 skips sharing (like
every prediction strategy), and a trimmed mean whose live sender count
n = M - 1 satisfies n - 2 trim < 1 falls back to the untrimmed mean.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.core.strategies.base import Payload, register
from repro_torch.core.strategies.dml import DML


class _RobustDML(DML):
    """Shared plumbing: hand the (mode, trim) spec to the population."""
    robust_mode = "trimmed"

    def __init__(self, kl_weight: float = 1.0, mutual_epochs: int = 1,
                 trim: int = 1):
        super().__init__(kl_weight=kl_weight, mutual_epochs=mutual_epochs)
        if trim < 0:
            raise ValueError(f"trim must be >= 0, got {trim}")
        self.trim = int(trim)

    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        out = pop.mutual_phase(
            r, part, pm, payload, self.kl_weight, self.mutual_epochs,
            sparse_k=0, robust=(self.robust_mode, self.trim))
        payload.positions = int(out.get("positions", 0))
        return out


@register
class TrimmedDML(_RobustDML):
    """Coordinate-wise trimmed-mean consensus: drop the ``trim`` largest
    and smallest received values per shared position, average the rest.
    Tolerates up to ``trim`` poisoned participants per round."""
    name = "trimmed-dml"
    robust_mode = "trimmed"


@register
class MedianDML(_RobustDML):
    """Coordinate-wise median consensus, the maximally trimmed mean;
    ``trim`` is accepted for CLI symmetry but unused."""
    name = "median-dml"
    robust_mode = "median"
