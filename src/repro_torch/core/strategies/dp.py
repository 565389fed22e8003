"""DP-DML (``repro/core/strategies/dp.py``) -- the paper's prediction-
sharing protocol with a differential privacy guarantee on what crosses the
wire.

Every mutual epoch each participant's public-set predictions are
L2-clipped and Gaussian-noised (``privacy.dp``) BEFORE they are shared,
so the only tensor that ever leaves a client is an (epsilon, delta)-DP
release; the strategy owns the Renyi accountant (``privacy.accountant``)
that composes those releases across epochs and rounds.  Comm bytes are
identical to dense DML: noise is free on the wire.

The strategy is STATEFUL (accountant + noise key), so it takes part in
the ``Federation`` checkpoint through ``state_dict``/``load_state_dict``
in the JAX package's schema.  The key is the JAX package's raw PRNG key
words, (0, dp_seed ^ 0xD9E57A11) at the start; it advances exactly once
per round, sharing or not, so a resumed session draws what an
uninterrupted one does.  The advance is the port's own (numpy), as the
draws it seeds are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core.strategies.base import Payload, register
from repro_torch.core.strategies.dml import DML
from repro_torch.privacy.accountant import RDPAccountant
from repro_torch.privacy.dp import DPSpec


@register
class DPDML(DML):
    """Dense DML with clipped + Gaussian-noised prediction payloads.

    ``dp_clip``: L2 bound on each client's flattened per-epoch payload.
    ``dp_noise_multiplier``: noise std in units of ``dp_clip``.
    ``dp_delta``: the delta at which ``epsilon()`` reports the guarantee.
    ``dp_seed``: seeds the noise key chain (independent of the
    population's model/data seeds).
    """
    name = "dp-dml"

    def __init__(self, kl_weight: float = 1.0, mutual_epochs: int = 1,
                 dp_clip: float = 1.0, dp_noise_multiplier: float = 1.0,
                 dp_delta: float = 1e-5, dp_seed: int = 0):
        super().__init__(kl_weight=kl_weight, mutual_epochs=mutual_epochs)
        if dp_clip <= 0:
            raise ValueError(f"dp_clip must be > 0, got {dp_clip}")
        if dp_noise_multiplier <= 0:
            raise ValueError("dp_noise_multiplier must be > 0, got "
                             f"{dp_noise_multiplier} (use DML for the "
                             "noiseless protocol)")
        self.dp_clip = float(dp_clip)
        self.dp_noise_multiplier = float(dp_noise_multiplier)
        self.dp_delta = float(dp_delta)
        self.accountant = RDPAccountant()
        self._noise_key = np.array(
            [0, (dp_seed ^ 0xD9E57A11) & 0xFFFFFFFF], np.uint32)

    def _advance(self) -> Tuple[np.ndarray, np.ndarray]:
        """The round's step of the key chain: (the next key, the (E, 2)
        uint32 epoch keys), both drawn from the current key."""
        rng = np.random.default_rng(self._noise_key)
        key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
        keys = rng.integers(0, 2 ** 32, size=(self.mutual_epochs, 2),
                            dtype=np.uint32)
        return key, keys

    # -- protocol ----------------------------------------------------------
    def combine(self, pop, r: int, part: List[int], pm,
                payload: Payload) -> Dict[str, Any]:
        # the key advances EVERY round (shared or not), so a restored
        # session replays the identical noise stream
        self._noise_key, keys = self._advance()
        out = pop.mutual_phase(
            r, part, pm, payload, self.kl_weight, self.mutual_epochs,
            sparse_k=0,
            dp=DPSpec(clip=self.dp_clip,
                      noise_multiplier=self.dp_noise_multiplier, keys=keys))
        if out.get("ran"):
            # one Gaussian release per mutual epoch per client: the curve
            # is the PER-CLIENT epsilon (each client's own data only enters
            # its own releases)
            self.accountant.step(self.dp_noise_multiplier,
                                 releases=self.mutual_epochs)
        payload.positions = int(out.get("positions", 0))
        out["epsilon"] = self.epsilon()
        return out

    def epsilon(self) -> float:
        """The session's (epsilon, dp_delta) guarantee so far, per client."""
        return self.accountant.epsilon(self.dp_delta)

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"accountant": self.accountant.state(),
                "noise_key": [int(w) for w in self._noise_key],
                "dp_clip": self.dp_clip,
                "dp_noise_multiplier": self.dp_noise_multiplier,
                "dp_delta": self.dp_delta}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for knob in ("dp_clip", "dp_noise_multiplier", "dp_delta"):
            want, have = float(state[knob]), float(getattr(self, knob))
            if want != have:
                raise ValueError(
                    f"checkpoint {knob}={want} != session {knob}={have}; "
                    "the accountant's curve is only valid for the noise "
                    "schedule it recorded")
        self.accountant.load_state(state["accountant"])
        self._noise_key = np.asarray(state["noise_key"],
                                     np.uint32).reshape(2)
