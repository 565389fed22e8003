"""Rényi (moments) accountant for the Gaussian-mechanism releases DP-DML
makes (``repro/privacy/accountant.py``, copied whole: the same calls give
the same floats) -- pure Python math, checkpointable.

Every mutual epoch each participant releases ONE clipped +
Gaussian-noised payload (its public-set predictions), i.e. one Gaussian
mechanism invocation with L2 sensitivity ``clip`` and noise std
``clip * noise_multiplier``.  The Rényi divergence of that mechanism is

    eps_rdp(alpha) = alpha / (2 sigma^2)          (sigma = noise_multiplier)

and RDP composes additively across releases, so the whole federation's
privacy curve is a single coefficient

    S = sum_t 1 / (2 sigma_t^2)      with   eps_rdp(alpha) = alpha * S.

Conversion to (ε, δ) uses the standard RDP-to-DP bound
``eps = eps_rdp(alpha) + log(1/δ)/(alpha-1)`` minimised over alpha > 1,
which for the linear-in-alpha curve above has the closed-form minimiser
``alpha* = 1 + sqrt(log(1/δ)/S)`` giving

    eps(δ) = S + 2 sqrt(S log(1/δ)).

For a SINGLE release (S = 1/(2σ²)) this collapses to the textbook
Gaussian-mechanism RDP bound ``1/(2σ²) + sqrt(2 log(1/δ))/σ`` —
``gaussian_epsilon`` below — which the tests hold the accountant to
within 1e-6 (the oracle is also re-derived numerically over an alpha
grid there).

No subsampling amplification is modelled: every participant releases its
full payload every mutual epoch, so the sampling rate is 1 and plain RDP
composition is tight for this protocol.
"""
from __future__ import annotations

import math
from typing import Dict, List


def gaussian_epsilon(noise_multiplier: float, delta: float) -> float:
    """Closed-form single-release (ε, δ) of the Gaussian mechanism with
    noise std = ``noise_multiplier`` × sensitivity, via the RDP curve
    alpha/(2σ²) optimised analytically over alpha."""
    if noise_multiplier <= 0:
        return math.inf
    if not 0 < delta < 1:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    s = noise_multiplier
    return 1.0 / (2 * s * s) + math.sqrt(2 * math.log(1 / delta)) / s


class RDPAccountant:
    """Tracks the composed RDP coefficient of a sequence of (full-batch)
    Gaussian releases and converts it to (ε, δ) on demand.

    ``step(noise_multiplier, releases=n)`` records n releases at that
    noise level; ``epsilon(delta)`` returns the tightest ε the linear RDP
    curve yields.  ``state()``/``load_state()`` round-trip everything
    (used by ``DPDML.state_dict`` through ``Federation``).
    """

    def __init__(self) -> None:
        self._coeff = 0.0            # S = sum_t 1/(2 sigma_t^2)
        self._releases = 0
        self._log: List[Dict] = []   # [{"sigma": s, "releases": n}, ...]

    # -- recording ---------------------------------------------------------
    def step(self, noise_multiplier: float, releases: int = 1) -> None:
        if noise_multiplier <= 0:
            raise ValueError(
                f"noise_multiplier must be > 0, got {noise_multiplier} "
                "(a noiseless release has no finite privacy curve)")
        if releases <= 0:
            return
        self._coeff += releases / (2.0 * noise_multiplier ** 2)
        self._releases += int(releases)
        # coalesce the (very common) same-sigma streak so the log stays
        # O(#distinct sigmas), not O(#rounds)
        if self._log and self._log[-1]["sigma"] == float(noise_multiplier):
            self._log[-1]["releases"] += int(releases)
        else:
            self._log.append({"sigma": float(noise_multiplier),
                              "releases": int(releases)})

    @property
    def releases(self) -> int:
        return self._releases

    @property
    def rdp_coeff(self) -> float:
        """S such that eps_rdp(alpha) = alpha * S."""
        return self._coeff

    # -- conversion --------------------------------------------------------
    def best_alpha(self, delta: float) -> float:
        """The alpha that minimises the RDP-to-DP conversion."""
        if self._coeff <= 0:
            return math.inf
        return 1.0 + math.sqrt(math.log(1 / delta) / self._coeff)

    def epsilon(self, delta: float) -> float:
        """(ε, δ)-DP guarantee of everything recorded so far."""
        if not 0 < delta < 1:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if self._coeff <= 0:
            return 0.0
        s = self._coeff
        return s + 2.0 * math.sqrt(s * math.log(1 / delta))

    # -- checkpoint --------------------------------------------------------
    def state(self) -> Dict:
        return {"coeff": self._coeff, "releases": self._releases,
                "log": [dict(e) for e in self._log]}

    def load_state(self, state: Dict) -> None:
        self._coeff = float(state["coeff"])
        self._releases = int(state["releases"])
        self._log = [dict(e) for e in state.get("log", [])]


def calibrate_noise(target_epsilon: float, delta: float, releases: int,
                    tol: float = 1e-9) -> float:
    """Smallest noise multiplier whose ``releases``-fold composition stays
    within (target_epsilon, delta) — the inverse of the accountant, via
    bisection on sigma (epsilon is strictly decreasing in sigma)."""
    if target_epsilon <= 0:
        raise ValueError(f"target_epsilon must be > 0, got {target_epsilon}")
    if releases <= 0:
        raise ValueError(f"releases must be > 0, got {releases}")

    def eps(sigma: float) -> float:
        s = releases / (2.0 * sigma * sigma)
        return s + 2.0 * math.sqrt(s * math.log(1 / delta))

    lo, hi = 1e-3, 1.0
    while eps(hi) > target_epsilon:
        hi *= 2.0
        if hi > 1e9:
            raise ValueError("cannot calibrate: target epsilon too small")
    while hi - lo > tol * hi:
        mid = 0.5 * (lo + hi)
        if eps(mid) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi
