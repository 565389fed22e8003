"""Prediction-sharing strategies (``repro/core/strategies/dml.py``): the
paper's proposal (dense Eq. 1/2 DML) and its bandwidth-constrained variant
(sparse top-k sharing).

Dense DML moves, per mutual epoch, every participant's predictions on the
shared public positions up and the (M, positions) broadcast back down.
SparseDML moves only the top-k (index, log-prob) pairs: bytes drop by
V / (2k), and the receiver treats the residual mass as uniform over the
tail (``mutual.sparse_share_bytes`` / ``mutual.sparse_mutual_kl_loss``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.mutual import sparse_share_bytes
from repro_torch.core.strategies.base import Payload, register


@register
class DML:
    """Eq.-1 descent against received predictions.

    ``kl_weight``: weight of the Eq.-2 KLD term in Eq. 1.
    ``mutual_epochs``: share + descend passes per round (sharing happens
    EVERY epoch -- comm scales with it).
    """
    name = "dml"
    sparse_k = 0

    def __init__(self, kl_weight: float = 1.0, mutual_epochs: int = 1):
        self.kl_weight = float(kl_weight)
        self.mutual_epochs = int(mutual_epochs)

    def local_phase(self, pop, r: int, part: List[int],
                    pm) -> Optional[List[float]]:
        if getattr(pop, "fused_dml", False):
            return None                      # combine covers local + mutual
        return pop.local_phase(r, part, pm)

    def round_payload(self, pop, r: int, part: List[int]) -> Payload:
        kind = "sparse-predictions" if self.sparse_k else "predictions"
        return Payload(kind=kind, data=pop.public_payload(r))

    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        out = pop.mutual_phase(r, part, pm, payload, self.kl_weight,
                               self.mutual_epochs, sparse_k=self.sparse_k)
        payload.positions = int(out.get("positions", 0))
        return out

    def comm_bytes(self, pop, part: List[int], payload: Payload,
                   out: Dict[str, Any]) -> int:
        if not out.get("ran"):
            return 0
        # every mutual epoch each of the M participants ships its
        # (positions,) x V-wide predictions up and receives the
        # (M, positions) broadcast down
        per_epoch = 2 * len(part) * payload.positions * \
            pop.bytes_per_position
        return self.mutual_epochs * per_epoch


@register
class SparseDML(DML):
    """Top-k prediction sharing: clients publish only (indices, log-probs)
    of their k most likely classes; the receiver rebuilds ~P with a
    uniform tail."""
    name = "sparse-dml"

    def __init__(self, k: int = 64, kl_weight: float = 1.0,
                 mutual_epochs: int = 1):
        super().__init__(kl_weight=kl_weight, mutual_epochs=mutual_epochs)
        if k <= 0:
            raise ValueError(f"SparseDML needs k > 0, got {k}")
        self.sparse_k = int(k)

    def comm_bytes(self, pop, part: List[int], payload: Payload,
                   out: Dict[str, Any]) -> int:
        if not out.get("ran"):
            return 0
        return self.mutual_epochs * sparse_share_bytes(
            len(part), payload.positions, self.sparse_k)
