"""LLM-scale stacked client population -- the ``core.distributed`` steps
behind the ``Federation`` session layer (``repro/core/populations/lm.py``).

K same-arch clients live as a leading axis on every param and optimizer
leaf.  Per strategy, one round is:

  - dml / sparse-dml: ONE fused update (``distributed.make_dml_train_step``):
    private CE + Eq. 1 on the round's public batch, the Eq.-2 term against
    the full public logits or their top-k sets;
  - fedavg / async: ``make_local_train_step`` for the local phase, then
    ``fedavg_sync`` / ``async_sync`` on the stacked axis.

With a client mesh (``LMClients(..., mesh=...)``, a ``sharding.ClientMesh``)
the dml round runs ``distributed.make_sharded_dml_step``: each entry owns
whole clients, and the public logits are gathered once a round.  The state
stays in the entry layout between rounds (``base.MeshState``); other
strategies are refused on a mesh, as in the JAX package.

Private data is per-client synthetic bigram streams (one domain per
client -- non-IID); the public batch is fresh every round.  The batches
are the JAX package's, token for token.  A prefix-token arch also draws
its conditioning embeddings as the JAX package does (``_prefix``): N(0, 1)
from a generator seeded by the round alone, one private draw shared by
every client, a public one at 10_000 + r and an eval one at 777_000.

``device=None`` means the CUDA device and raises without one; pass
``device="cpu"`` to run on the CPU.  The kernel impl is resolved once here
(``ops.resolve_impl``: "cuda" on the card, "ref" on the CPU) and passed
down to every step.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core.async_fl import layer_schedule
from repro_torch.core.populations.base import (MeshState, Population,
                                               broadcast_mask_counts)
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig
from repro_torch.trace import count, span, to_host
from repro_torch.tree import tree_leaves, tree_map


class LMClients(MeshState, Population):
    """K stacked same-arch LM clients on synthetic domain streams."""

    engine_name = "lm"
    supported = frozenset({"dml", "sparse-dml", "fedavg", "async"})
    fused_dml = True
    log_participants_always = True

    def __init__(self, cfg, n_clients: int = 2, rounds: int = 20,
                 batch: int = 4, seq: int = 64, lr: float = 1e-3,
                 seed: int = 0, mesh=None, device=None, kernel_impl=None):
        self.cfg = cfg
        self.n_clients = n_clients
        self.rounds = rounds
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.mesh = mesh
        self.device = ops.resolve_device(device)
        self.impl = ops.resolve_impl(kernel_impl, self.device)
        self.opt_cfg = AdamWConfig(lr=lr, warmup=5, total_steps=rounds)
        self.client_params = D.stacked_init(seed, cfg, n_clients,
                                            device=self.device)
        self.client_opts = D.stacked_adamw_init(self.client_params)
        self._steps = {}
        self._last_metrics = {}
        self._shallow = None           # the async baseline's lerp mask

    def validate_strategy(self, strategy) -> None:
        super().validate_strategy(strategy)
        if getattr(strategy, "mutual_epochs", 1) != 1:
            raise ValueError(
                "the LM population fuses the whole round into one update; "
                "mutual_epochs must be 1")
        if self.mesh is not None and strategy.name != "dml":
            raise ValueError(
                "mesh-sharded LM rounds support the dense dml strategy "
                f"only (make_sharded_dml_step), got {strategy.name!r}")

    # -- data -------------------------------------------------------------
    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        """The host's tokens on the device: a synchronous copy from
        pageable memory, so a ``host_sync``."""
        count("host_sync")
        return torch.as_tensor(toks, dtype=torch.long, device=self.device)

    def _private_batch(self, r: int) -> torch.Tensor:
        """(K, B, S) tokens -- each client has its own bigram domain."""
        with span("repro.lm.private_batch"):
            return self._tokens(np.stack([
                make_token_stream(self.batch, self.seq + 1,
                                  self.cfg.vocab_size,
                                  seed=1000 * r + self.seed,
                                  domain=d)[:, :self.seq]
                for d in range(self.n_clients)]))

    def _public_batch(self, r: int) -> torch.Tensor:
        """(B_pub, S) fresh public tokens from an unseen domain."""
        with span("repro.lm.public_batch"):
            return self._tokens(make_token_stream(
                max(1, self.batch // 2), self.seq + 1, self.cfg.vocab_size,
                seed=1000 * (10_000 + r) + self.seed,
                domain=self.n_clients)[:, :self.seq])

    def _prefix(self, r: int, batch: int):
        """(B, P, pd) fp32 conditioning embeddings for a prefix-token arch
        (``cfg.prefix_tokens`` > 0), None otherwise: the JAX package's draw
        (``repro/core/populations/lm.py:94-102``), seeded by ``r`` alone."""
        if not self.cfg.prefix_tokens:
            return None
        rng = np.random.default_rng(r)
        count("host_sync")
        return torch.as_tensor(rng.normal(
            0, 1, (batch, self.cfg.prefix_tokens, self.cfg.prefix_dim)
        ).astype(np.float32), device=self.device)

    def _private_prefix(self, r: int):
        """(K, B, P, pd): round ``r``'s one draw, every client's (a view)."""
        p = self._prefix(r, self.batch)
        if p is None:
            return None
        return p.expand(self.n_clients, *p.shape)

    # -- cached steps -----------------------------------------------------
    def _dml_step(self, kl_weight: float, sparse_k: int):
        key = ("dml", kl_weight, sparse_k, self.mesh)
        if key not in self._steps:
            if self.mesh is not None:
                self._steps[key] = D.make_sharded_dml_step(
                    self.cfg, self.opt_cfg, self.mesh, self.n_clients,
                    kl_weight=kl_weight, impl=self.impl)
            else:
                self._steps[key] = D.make_dml_train_step(
                    self.cfg, self.opt_cfg, kl_weight=kl_weight,
                    sparse_k=sparse_k, impl=self.impl)
        return self._steps[key]

    def _local_step(self):
        if "local" not in self._steps:
            self._steps["local"] = D.make_local_train_step(
                self.cfg, self.opt_cfg, impl=self.impl)
        return self._steps["local"]

    # -- strategy capabilities --------------------------------------------
    def local_phase(self, r: int, part: List[int], pm) -> List[float]:
        part_mask = pm if len(part) < self.n_clients else None
        self.client_params, self.client_opts, m = self._local_step()(
            self.client_params, self.client_opts, self._private_batch(r),
            self._private_prefix(r), part_mask)
        self._last_metrics = m
        return [float(x) * w for x, w in zip(to_host(m["ce"]), pm)]

    def public_payload(self, r: int):
        return self._public_batch(r)

    def mutual_phase(self, r, part, pm, payload, kl_weight, mutual_epochs,
                     sparse_k: int = 0) -> dict:
        pub = payload.data
        if len(part) < 2:
            # nothing to share with: participants train locally only
            losses = self.local_phase(r, part, pm)
            return {"ran": False, "positions": 0, "client_loss": losses,
                    "kl_loss": [0.0] * self.n_clients}
        if sparse_k and len(part) < self.n_clients:
            raise ValueError("sparse top-k sharing + partial participation "
                             "is not supported by the fused LM step")
        part_mask = pm if len(part) < self.n_clients else None
        step = self._dml_step(kl_weight, sparse_k)
        if self.mesh is not None:
            # no prefix: the sharded step refuses prefix-token archs
            m = step.on_entries(*self._to_mesh(), self._private_batch(r),
                                pub, part_mask=part_mask)
        else:
            self.client_params, self.client_opts, m = step(
                self.client_params, self.client_opts, self._private_batch(r),
                pub, prefix=self._private_prefix(r),
                public_prefix=self._prefix(10_000 + r, int(pub.shape[0])),
                part_mask=part_mask)
        self._last_metrics = m
        return {"ran": True,
                "positions": int(pub.shape[0]) * int(pub.shape[1]),
                "client_loss": to_host(m["private_loss"]),
                "public_ce": to_host(m["public_ce"]),
                "kl_loss": to_host(m["kld_avg"])}

    def fedavg_combine(self, part: List[int], pm) -> None:
        full = len(part) == self.n_clients
        D.fedavg_sync(self.client_params, None if full else pm)

    def async_combine(self, r, part, pm, delta, min_round, pub) -> str:
        ce = np.asarray(to_host(self._last_metrics["ce"].float()),
                        dtype=np.float32)
        # weighting metric: inverse local loss, masked so absentees
        # contribute no weight and receive nothing back
        scores = (1.0 / (1.0 + np.maximum(ce, 0.0))) * pm
        full = len(part) == self.n_clients
        D.async_sync(self.client_params, scores, self._shallow_mask(), r,
                     delta, min_round, part_mask=None if full else pm)
        return layer_schedule(r, delta, min_round)

    def _shallow_mask(self):
        if self._shallow is None:
            self._shallow = D.transformer_shallow_mask(self.cfg,
                                                       self.client_params)
        return self._shallow

    def async_param_counts(self):
        return broadcast_mask_counts(self.client_params,
                                     self._shallow_mask(), self.n_clients)

    @property
    def bytes_per_position(self) -> int:
        return self.cfg.vocab_size * 4

    @property
    def params_per_client(self) -> int:
        # one client's rows, in whichever layout the state is
        params = self._client_params if self._entries is None else \
            self._entries[0][0]
        return int(sum(t[0].numel() for t in tree_leaves(params)))

    # -- eval / checkpoint -------------------------------------------------
    @torch.no_grad()
    def evaluate(self, history, split=None):
        """Per-client CE on a fresh shared eval batch (domain K, never a
        training domain)."""
        if split is not None:
            raise ValueError(
                "the LM population evaluates on a fresh held-out synthetic "
                "batch; call evaluate() / evaluate(split=None)")
        toks = self._tokens(make_token_stream(
            self.batch, self.seq + 1, self.cfg.vocab_size,
            seed=777_000 + self.seed, domain=self.n_clients)[:, :self.seq])
        losses, _ = tfm.loss_fn_clients(self.client_params, self.cfg, toks,
                                        self._prefix(777_000, self.batch),
                                        impl=self.impl)
        history.client_eval_loss = losses.tolist()
        return history

    def state_dict(self) -> dict:
        return {"client_params": self.client_params,
                "client_opts": self.client_opts}

    def meta_dict(self) -> dict:
        return {"engine": self.engine_name, "arch": self.cfg.name,
                "n_clients": self.n_clients, "n_rounds": self.rounds}

    def check_meta(self, meta: dict) -> None:
        if meta.get("arch") != self.cfg.name or \
                meta.get("n_clients") != self.n_clients:
            raise ValueError(
                f"checkpoint (arch={meta.get('arch')}, "
                f"K={meta.get('n_clients')}) != config "
                f"(arch={self.cfg.name}, K={self.n_clients})")

    def load_state_dict(self, state: dict, meta: dict) -> None:
        """Takes trees of tensors on any device (a restored checkpoint's are
        on the CPU) and moves them to the population's device."""
        to = lambda t: torch.as_tensor(t).to(self.device)  # noqa: E731
        self._entries = None
        self.client_params = tree_map(to, state["client_params"])
        self.client_opts = tree_map(to, state["client_opts"])
