"""``Federation`` -- the one session object behind every federated run
(``repro/core/api.py``).

    Federation(population, strategy, participation=0)

composes a sharing **strategy** (``core.strategies``) with a client
**population** (``core.populations``).  The session owns the participation
sampler (``data.federated.sample_participants``, stateless in the round
index, so resume-safe), the round loop, the ``History``/``RoundLog``
ledger with its comm bytes, and the checkpoint schema: ``save_state`` /
``restore_state`` / ``export_for_serving`` go through
``repro_torch.checkpoint`` in the JAX package's npz + JSON schema, so a
session saved by either package restores in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import checkpoint
from repro_torch.data.federated import sample_participants
from repro_torch.trace import count, span


@dataclass
class RoundLog:
    """One round's ledger entry (``layer`` is async-only, ``public_ce``
    prediction-sharing-only)."""
    round: int
    client_loss: List[float]
    kl_loss: List[float]
    comm_bytes: int
    layer: Optional[str] = None
    participants: Optional[List[int]] = None      # None -> full participation
    public_ce: Optional[List[float]] = None


@dataclass
class History:
    """Session history shared by every strategy x population pairing."""
    rounds: List[RoundLog] = field(default_factory=list)
    client_test_acc: List[float] = field(default_factory=list)   # vision eval
    global_test_acc: float = 0.0                                 # vision eval
    client_eval_loss: List[float] = field(default_factory=list)  # lm eval
    total_comm_bytes: int = 0


class Federation:
    """One federated learning session: strategy x population x rounds.

    ``participation``: sample M <= K clients per round (0 -> all K);
    non-participants train nothing, share nothing, receive nothing, and
    comm costs scale with M.
    """

    def __init__(self, population, strategy, participation: int = 0):
        population.validate_strategy(strategy)
        self.population = population
        self.strategy = strategy
        self.participation = participation
        self.history = History()
        self.round = 0                     # next round to run

    @property
    def n_clients(self) -> int:
        return self.population.n_clients

    @property
    def rounds(self) -> int:
        return self.population.rounds

    @property
    def dispatch_log(self):
        """The population's (round, phase) entries, where it keeps them."""
        return getattr(self.population, "dispatch_log", [])

    def participants(self, r: int) -> List[int]:
        """The M clients sampled for round r (stateless in r)."""
        return sample_participants(self.n_clients, self.participation,
                                   self.population.seed, r)

    # -- rounds -----------------------------------------------------------
    def run(self, until: int = 0) -> History:
        """Run rounds up to ``until`` (0 -> population.rounds), from the
        round counter on, so a restored session continues where its
        checkpoint left off."""
        stop = until or self.rounds
        for r in range(self.round, min(stop, self.rounds)):
            self._run_round(r)
        return self.history

    def _run_round(self, r: int) -> None:
        with span("repro.round"):
            count("round")
            pop, strat = self.population, self.strategy
            pop.begin_round(r)
            part = self.participants(r)
            pm = pop.part_mask(part)
            local_losses = strat.local_phase(pop, r, part, pm)
            payload = strat.round_payload(pop, r, part)
            out = strat.combine(pop, r, part, pm, payload) or {}
            comm = strat.comm_bytes(pop, part, payload, out)
            K = self.n_clients
            full = len(part) == K
            self.history.total_comm_bytes += comm
            self.history.rounds.append(RoundLog(
                r,
                out.get("client_loss", local_losses or [0.0] * K),
                out.get("kl_loss", [0.0] * K),
                comm,
                layer=out.get("layer"),
                participants=part if (not full or
                                      pop.log_participants_always) else None,
                public_ce=out.get("public_ce")))
            self.round = r + 1

    # -- eval ----------------------------------------------------------------
    def evaluate(self, split=None) -> History:
        """Population-appropriate final evaluation (the LM population: per-
        client loss on a common held-out batch, ``split=None``)."""
        return self.population.evaluate(self.history, split)

    # -- checkpoint/resume -------------------------------------------------
    def save_state(self, path: str) -> None:
        """Population state plus the session's round counter, comm ledger
        and history, in the JAX package's schema."""
        meta = {
            **self.population.meta_dict(),
            "method": self.strategy.name,
            "round": self.round,
            "total_comm_bytes": self.history.total_comm_bytes,
            "rounds": [dataclasses.asdict(rl) for rl in self.history.rounds],
        }
        if hasattr(self.strategy, "state_dict"):
            meta["strategy_state"] = self.strategy.state_dict()
        checkpoint.save(path, self.population.state_dict(), meta)

    def export_for_serving(self, path: str) -> None:
        """The slim serving artifact: client params only, plus the meta the
        serving engine needs (``engine``/``arch``/``n_clients``)."""
        state = self.population.state_dict()
        if "client_params" not in state:
            raise ValueError(
                f"population {self.population.engine_name!r} does not "
                "expose a stacked 'client_params' tree")
        meta = {k: v for k, v in self.population.meta_dict().items()
                if k in ("engine", "arch", "n_clients")}
        meta["round"] = self.round
        checkpoint.save(path, {"client_params": state["client_params"]},
                        meta)

    def restore_state(self, path: str) -> None:
        """Load a ``save_state`` checkpoint (written by either package) into
        this session, which must be built with the same config."""
        state, meta = checkpoint.restore(path)
        method = meta.get("method", self.strategy.name)
        if method != self.strategy.name:
            raise ValueError(
                f"checkpoint strategy {method!r} != session strategy "
                f"{self.strategy.name!r}")
        self.population.check_meta(meta)
        if "strategy_state" in meta and hasattr(self.strategy,
                                                "load_state_dict"):
            self.strategy.load_state_dict(meta["strategy_state"])
        self.population.load_state_dict(state, meta)
        self.round = int(meta["round"])
        self.history = History(
            rounds=[RoundLog(**_round_kwargs(d))
                    for d in meta.get("rounds", [])],
            total_comm_bytes=int(meta.get("total_comm_bytes", 0)))


def _round_kwargs(d: Dict[str, Any]) -> Dict[str, Any]:
    """Accept round dicts of any schema generation: unknown keys are
    dropped.  A loss that was a numpy float32 when it was saved was written
    as its string (``json.dump(..., default=str)``, in either package: the
    VisionNet rounds' ``client_loss``); it is read back as that float32's
    value."""
    fields = {f.name for f in dataclasses.fields(RoundLog)}
    out = {k: v for k, v in d.items() if k in fields}
    for k in ("client_loss", "kl_loss", "public_ce"):
        if out.get(k) is not None:
            out[k] = [float(np.float32(x)) if isinstance(x, str) else x
                      for x in out[k]]
    return out
