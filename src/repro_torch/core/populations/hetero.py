"""Heterogeneous-client population -- the paper's section I motivation
("different IoT devices ... might use different architectures") as a
``Federation`` population (``repro/core/populations/hetero.py``).

Each client declares its own model family through the per-client registry
(``models.get_client_model``): dense transformer, attention-free SSM,
fine-grained MoE, or the paper's VisionNet.  Weight averaging is undefined
across these clients -- the trees do not even match -- but prediction
sharing does not care: the ONLY tensor that ever crosses a client boundary
is the (M, N_pub, V) stack of public-set logits (dense DML) or its top-k
compression (SparseDML), so the population works for any mix of families
that agree on the prediction space V.

Per round each participant runs its local epochs as a loop of AdamW steps
over its fixed-shape (T, B) batch plan (the JAX package's jitted
``lax.scan``; clients run one after another, each clipped by its own
global norm), then the mutual phase descends Eq. 1 against the received
predictions: ``mutual.kl_to_received`` (on the card the rectangular
pair-KL kernels, one live row against the J received) or
``mutual.sparse_kl_to_received`` (the sparse-KL kernels at Kl = 1).  The
stacks stay on the device; only their analytic bytes are booked.

Weight strategies (``fedavg`` / ``async``) are accepted ONLY when every
client declares the same arch (identical trees -- the degenerate case
where averaging is defined again); mixed fleets reject them at session
construction, which is the paper's point made executable.

``archs`` holds arch ids, as in the JAX package, or config objects (the
port's way to cut depth at full width; the id is then ``cfg.name``).
``device=None`` means the CUDA device and raises without one; the kernel
impl is resolved once (``ops.resolve_impl``).  Init draws and VisionNet
dropout draws are the port's own; parity crosses the JAX package's state
through ``load_state_dict`` (its npz schema).

Privacy and robustness, as in the JAX package: ``byzantine`` clients
(``label-flip`` poisons a vision client's local labels; ``sign-flip``
negates what a sender shares, ``collude`` replaces it by a one-hot of 8.0
at ``(label + 1) % V``, on the device and on the sent stack only), the DP
release of the whole (M, N_pub, V) stack each epoch (``DPDML``: one draw
of that shape an epoch, ``privacy.dp.gaussian``), the robust combiners
(``TrimmedDML`` / ``MedianDML``: ``mutual.kl_to_robust_received``, plain
PyTorch at every impl) and the payload tap (``record_payloads``: a host
copy of every epoch's stack in ``payload_log``).  Under DP-DML the Eq.-2
term still runs ``kl_to_received``: on the card the pair kernels against
the noised stack.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import stacking
from repro_torch.core.async_fl import layer_schedule
from repro_torch.core.mutual import (kl_to_received, kl_to_robust_received,
                                     sparse_kl_to_received, topk_predictions)
from repro_torch.core.populations.base import (Population,
                                               broadcast_mask_counts)
from repro_torch.data.federated import FoldScheduler, round_batch_indices
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels import ops
from repro_torch.models import ClientModel, get_client_model
from repro_torch.models.visionnet import strict_fp32
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.privacy import dp as dp_mod
from repro_torch.tree import tree_leaves, tree_map


def comm_bytes_per_round(n_participants: int, n_pub: int, n_classes: int,
                         mutual_epochs: int,
                         bytes_per_el: int = 4) -> Dict[str, int]:
    """Cost-accounting dict for one heterogeneous DML round.

    Every mutual epoch each of the M participants ships its (N_pub, V)
    logits up and receives the (M, N_pub, V) broadcast down -- the same
    up+down convention as the homogeneous engine, with bytes independent
    of any model's parameter count.
    """
    per_epoch = n_participants * n_pub * n_classes * bytes_per_el
    return {"per_epoch_up": per_epoch, "per_epoch_down": per_epoch,
            "round": mutual_epochs * 2 * per_epoch}


def make_lm_pool(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                 n_domains: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Token pool + domain labels for the fold schedule.

    Rows come from ``n_domains`` bigram rules; the domain id doubles as the
    stratification label so every fold mixes all domains (the IID setting).
    """
    per = -(-n_seqs // n_domains)
    parts = [make_token_stream(per, seq_len, vocab, seed=seed + d, domain=d)
             for d in range(n_domains)]
    data = np.concatenate(parts)[:n_seqs]
    labels = np.repeat(np.arange(n_domains), per)[:n_seqs]
    return data, labels.astype(np.int64)


def _arch_id(arch) -> str:
    return arch if isinstance(arch, str) else arch.name


def _without(stack: torch.Tensor, s: int) -> torch.Tensor:
    """``np.delete(stack, s, axis=0)``: a new contiguous tensor."""
    return torch.cat([stack[:s], stack[s + 1:]])


class HeteroClients(Population):
    """Architecture-heterogeneous clients on a (data, labels) pool.

    ``data``: (N, ...) examples -- token streams (N, S) for 'lm' clients,
    images (N, H, W, C) for 'vision' clients.  ``labels``: (N,) ints used
    for stratified folds (and as targets for 'vision' clients).  The JAX
    constructor's arguments, plus ``device``; ``kernel_impl`` None
    resolves from the device.
    """

    engine_name = "hetero"
    supported = frozenset({"dml", "sparse-dml", "fedavg", "async",
                           "dp-dml", "trimmed-dml", "median-dml"})
    log_participants_always = True
    _BYZ_MODES = ("label-flip", "sign-flip", "collude")

    def __init__(self, archs, data: np.ndarray, labels: np.ndarray,
                 rounds: int = 4, local_epochs: int = 1, batch_size: int = 4,
                 public_batch: int = 4, lr: float = 3e-3, seed: int = 0,
                 mutual_updates_per_round: int = 1, reduced: bool = True,
                 kernel_impl=None, byzantine=None,
                 record_payloads: bool = False, device=None):
        self.device = ops.resolve_device(device)
        self.archs = tuple(_arch_id(a) for a in archs)
        self.impl = ops.resolve_impl(kernel_impl, self.device)
        self.n_clients = len(self.archs)
        self.rounds = rounds
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.seed = seed
        # one ClientModel per unique arch; one params/opt tree per client
        self._models: Dict[str, ClientModel] = {}
        for a in archs:
            cm = get_client_model(a, reduced=reduced)
            if self._models.setdefault(cm.arch, cm).cfg != cm.cfg:
                raise ValueError(f"two configs named {cm.arch!r}; an arch "
                                 "id names one model")
        # the JAX package's checks, in its order, before any allocation
        kinds = {m.kind for m in self._models.values()}
        if len(kinds) != 1:
            raise ValueError(f"clients mix modalities {sorted(kinds)}; a "
                             "federation needs one public-set modality")
        self.kind = kinds.pop()
        spaces = {m.n_classes for m in self._models.values()}
        if len(spaces) != 1:
            raise ValueError(f"clients disagree on the prediction space V "
                             f"({sorted(spaces)}); shared vocab required")
        self.n_classes = spaces.pop()
        self.byzantine = {int(c): m for c, m in (byzantine or {}).items()}
        self._check_byzantine(self.byzantine)
        self.record_payloads = bool(record_payloads)
        self.payload_log: List[dict] = []
        self.opt_cfg = AdamWConfig(
            lr=lr, warmup=2,
            total_steps=max(rounds * (local_epochs
                                      + mutual_updates_per_round), 1))
        self.labels = labels
        # the pool, on the device once; every batch is gathered there
        self._data = torch.as_tensor(
            data, dtype=torch.long if self.kind == "lm" else torch.float32,
            device=self.device)
        self._labels = torch.as_tensor(labels, device=self.device)
        self.client_params = [
            self._models[a].init(self._init_seed(c), self.device)
            for c, a in enumerate(self.archs)]
        self.client_opts = [adamw_init(p) for p in self.client_params]
        self.n_params = [sum(t.numel() for t in tree_leaves(p))
                         for p in self.client_params]
        # Algorithm-1 fold discipline; the init fold (the homogeneous
        # engine's global-model fold -- there is no global model here)
        # becomes a common held-out eval fold
        self.folds = FoldScheduler(labels, self.n_clients, rounds,
                                   seed=seed)
        min_fold = len(labels) // self.folds.n_folds
        self._pub_n = max(1, min(public_batch, min_fold))
        self._local_T = local_epochs * max(1, min_fold // batch_size)
        self.eval_fold = self.folds.pop()[:max(self._pub_n, 1)]
        self._plan_seed = seed * 100_003 + 29
        self._last_local_losses: List[float] = [0.0] * self.n_clients
        self._shallow = None

    def _check_byzantine(self, byzantine: dict) -> None:
        """The JAX package's checks of the byzantine map."""
        for c, mode in byzantine.items():
            if not 0 <= c < self.n_clients:
                raise ValueError(
                    f"byzantine client {c} out of range (K={self.n_clients})")
            if mode not in self._BYZ_MODES:
                raise ValueError(
                    f"unknown byzantine mode {mode!r} for client {c}; "
                    f"HeteroClients supports {self._BYZ_MODES}")
            if mode == "label-flip" and self.kind == "lm":
                raise ValueError(
                    "label-flip is undefined for 'lm' clients (the private "
                    "loss is next-token CE on the inputs; labels are only "
                    "fold-stratification ids) -- use sign-flip or collude")

    def validate_strategy(self, strategy) -> None:
        super().validate_strategy(strategy)
        if strategy.name in ("fedavg", "async") and \
                len(set(self.archs)) > 1:
            raise ValueError(
                f"strategy {strategy.name!r} shares weights, which is "
                f"undefined across heterogeneous clients (archs "
                f"{sorted(set(self.archs))} have different pytrees).  Use "
                "prediction sharing (dml / sparse-dml), or a fleet of one "
                "arch.")
        if strategy.name == "async" and self.kind != "lm":
            raise ValueError(
                "the async shallow/deep schedule on this population uses "
                "the transformer layer split; non-'lm' fleets "
                f"(kind={self.kind!r}) should use the VisionClients "
                "population for AsyncWeights")

    # -- helpers ----------------------------------------------------------
    def _init_seed(self, c: int) -> int:
        return int(np.random.SeedSequence([self.seed, 0xC11E47, c])
                   .generate_state(1)[0])

    def _generator(self, r: int, tag: int):
        """The dropout generator of one (round, purpose) for a vision fleet
        (the port's own draws, fixed by seed, round and tag, so a resumed
        session draws what an uninterrupted one does); None for LM
        clients, which draw nothing."""
        if self.kind != "vision":
            return None
        seed = np.random.SeedSequence([self.seed, r, tag]).generate_state(1)
        return torch.Generator(device=self.device).manual_seed(int(seed[0]))

    def _precision(self):
        """VisionNet in full fp32 (no TF32), as ``VisionClients`` runs it."""
        return strict_fp32() if self.kind == "vision" else \
            contextlib.nullcontext()

    @property
    def _kl_impl(self) -> str:
        """The Eq.-2 impl: the population's for LM clients; the Bernoulli
        lift (V = 2) runs the plain version, as no VisionNet path of the
        port launches a kernel."""
        return self.impl if self.kind == "lm" else "ref"

    def _gather(self, idx: np.ndarray):
        i = torch.as_tensor(idx, device=self.device)
        return self._data[i], self._labels[i]

    def _step(self, c: int, loss) -> tuple:
        """One AdamW step of client c on ``loss(params) -> (total, aux)``:
        returns aux (detached)."""
        _, aux, grads = D.value_and_grad(loss, self.client_params[c])
        adamw_update(self.client_params[c], grads, self.client_opts[c],
                     self.opt_cfg)
        return aux

    def _mutual_step(self, c: int, inputs, labs, received, kl_weight: float,
                     gen, robust=None) -> tuple:
        """Eq. 1 with the received predictions fixed (one mutual epoch of
        client c): ``received`` is the (J, N_pub, V) logits or, for
        SparseDML, the (idx, logp) (J, N_pub, k) sets; ``robust`` (mode,
        trim) descends the KL to their robust consensus instead.  Returns
        (ce, kl)."""
        cm = self._models[self.archs[c]]

        def loss(p):
            ce, live = cm.public_ce_and_logits(p, inputs, labs, gen,
                                               impl=self.impl)
            if isinstance(received, tuple):
                terms = sparse_kl_to_received(live, *received,
                                              impl=self._kl_impl)
            elif robust is not None:
                terms = kl_to_robust_received(live, received, robust[0],
                                              int(robust[1]))
            else:
                terms = kl_to_received(live, received, impl=self._kl_impl)
            kl = torch.mean(terms)
            return ce + kl_weight * kl, torch.stack([ce, kl]).detach()

        with self._precision():
            return tuple(self._step(c, loss).tolist())

    @property
    def bytes_per_position(self) -> int:
        return self.n_classes * 4

    @property
    def params_per_client(self) -> int:
        return self.n_params[0]

    # -- strategy capabilities --------------------------------------------
    def local_phase(self, r: int, part: List[int], pm) -> List[float]:
        K = self.n_clients
        self._plan_seed += 1
        # K folds popped in Algorithm-1 order regardless of participation
        # (the fold budget is part of the protocol); the absentees' folds
        # go unused this round
        folds = [self.folds.pop() for _ in range(K)]
        local_losses = [0.0] * K
        for c in part:
            idx, _ = round_batch_indices([folds[c]], self.local_epochs,
                                         self.batch_size,
                                         seed=self._plan_seed * K + c)
            idx = idx[0, :self._local_T]
            if idx.shape[0] == 0:
                continue
            cm = self._models[self.archs[c]]
            gen = self._generator(r, 100 + c)
            losses = []
            with self._precision():
                for t in range(idx.shape[0]):
                    inputs, labs = self._gather(idx[t])
                    if self.byzantine.get(c) == "label-flip":
                        labs = (labs + 1) % self.n_classes

                    def loss(p):
                        total = cm.private_loss(p, inputs, labs, gen,
                                                impl=self.impl)
                        return total, total.detach()
                    losses.append(self._step(c, loss))
            local_losses[c] = float(torch.mean(torch.stack(losses)))
        self._last_local_losses = local_losses
        return local_losses

    def public_payload(self, r: int):
        # the rotating public fold, truncated to the public-batch budget
        return self.folds.pop()[:self._pub_n]

    def weights_payload(self, r: int):
        return self.folds.pop()[:self._pub_n]

    def _poison_stack(self, stack: torch.Tensor, part: List[int],
                      pub_labs: torch.Tensor) -> torch.Tensor:
        """Apply the payload Byzantine modes to the senders' rows of the
        (M, N_pub, V) logit stack, in place on the device: what they put
        on the wire.  Their own receipts stay honest; the attack is on what
        they SEND."""
        for s, c in enumerate(part):
            mode = self.byzantine.get(c)
            if mode == "sign-flip":
                stack[s] = -stack[s]
            elif mode == "collude":
                wrong = (pub_labs.long() + 1) % self.n_classes
                stack[s] = 0
                stack[s, torch.arange(len(pub_labs), device=stack.device),
                      wrong] = 8.0
        return stack

    def mutual_phase(self, r, part, pm, payload, kl_weight, mutual_epochs,
                     sparse_k: int = 0, dp=None, robust=None) -> dict:
        K = self.n_clients
        inputs, labs = self._gather(payload.data)
        public_ce = [0.0] * K
        kl_losses = [0.0] * K
        out = {"ran": False, "positions": 0, "public_ce": public_ce,
               "kl_loss": kl_losses}
        if sparse_k and (dp is not None or robust is not None):
            raise ValueError("sparse payloads compose with neither the DP "
                             "release nor the robust combiners")
        if mutual_epochs <= 0 or len(part) < 2:
            return out
        n_pub = None
        for e in range(mutual_epochs):
            # every participant publishes; ONLY these tensors cross
            # client boundaries
            with self._precision():
                shared = [self._models[self.archs[c]].share_logits(
                    self.client_params[c], inputs, impl=self.impl)
                    for c in part]
            if sparse_k:
                sets = [topk_predictions(x, sparse_k) for x in shared]
                idx_stack = torch.stack([s[0] for s in sets])  # (M,N_pub,k)
                logp_stack = torch.stack([s[1] for s in sets])
                n_pub = idx_stack.shape[1]
            else:
                stack = torch.stack(shared)                    # (M,N_pub,V)
                shared.clear()
                stack = self._poison_stack(stack, part, labs)
                if dp is not None:
                    # the whole stacked payload noised at once: one release
                    # per sender (leading-axis slices), one draw an epoch
                    noise = dp_mod.gaussian(dp.keys[e], stack.shape,
                                            self.device)
                    stack = dp_mod.dp_noise_payload(
                        stack, dp.clip, dp.noise_multiplier, noise)
                    del noise
                if self.record_payloads:
                    self.payload_log.append(
                        {"round": r, "epoch": e, "part": list(part),
                         "public": np.asarray(payload.data),
                         "payloads": stack.to("cpu", copy=True)})
                n_pub = stack.shape[1]
            del shared
            for s, c in enumerate(part):
                received = ((_without(idx_stack, s), _without(logp_stack, s))
                            if sparse_k else _without(stack, s))
                ce, kl = self._mutual_step(c, inputs, labs, received,
                                           kl_weight,
                                           self._generator(r, 1000 + e * K
                                                           + c), robust)
                public_ce[c] = ce
                kl_losses[c] = kl
                del received
        return {"ran": True, "positions": n_pub, "public_ce": public_ce,
                "kl_loss": kl_losses}

    # -- weight strategies: the identical-arch degenerate case -------------
    def _stacked(self):
        return stacking.stack_params(self.client_params)

    def _unstack_into(self, stacked) -> None:
        self.client_params = stacking.unstack_params(stacked,
                                                     self.n_clients)

    def fedavg_combine(self, part: List[int], pm) -> None:
        stacked = self._stacked()
        full = len(part) == self.n_clients
        D.fedavg_sync(stacked, None if full else pm)
        self._unstack_into(stacked)

    def async_combine(self, r, part, pm, delta, min_round, pub) -> str:
        stacked = self._stacked()
        # weighting metric: inverse local loss (the engine has no
        # per-client held-out accuracy for LM clients), masked so
        # absentees contribute nothing and receive nothing back
        scores = np.asarray(
            [1.0 / (1.0 + max(x, 0.0)) for x in self._last_local_losses],
            np.float32) * pm
        full = len(part) == self.n_clients
        D.async_sync(stacked, scores, self._shallow_mask(stacked), r, delta,
                     min_round, part_mask=None if full else pm)
        self._unstack_into(stacked)
        return layer_schedule(r, delta, min_round)

    def _shallow_mask(self, stacked):
        if self._shallow is None:
            cfg = self._models[self.archs[0]].cfg
            self._shallow = D.transformer_shallow_mask(cfg, stacked)
        return self._shallow

    def async_param_counts(self):
        stacked = self._stacked()
        return broadcast_mask_counts(stacked, self._shallow_mask(stacked),
                                     self.n_clients)

    # -- eval -------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, history, split=None):
        """Per-client model loss on the common held-out fold (comparable
        across families -- it is the same public-style CE every client
        optimises in Eq. 1)."""
        if split is not None:
            raise ValueError(
                "the hetero population evaluates on its held-out common "
                "fold; call evaluate() / evaluate(split=None)")
        inputs, labs = self._gather(self.eval_fold)
        with self._precision():
            history.client_eval_loss = [
                float(self._models[a].public_ce_and_logits(
                    p, inputs, labs, None, impl=self.impl)[0])
                for a, p in zip(self.archs, self.client_params)]
        return history

    # -- checkpoint/resume ------------------------------------------------
    def state_dict(self) -> dict:
        return {"clients": [{"params": p, "opt": o} for p, o in
                            zip(self.client_params, self.client_opts)]}

    def meta_dict(self) -> dict:
        return {
            "engine": self.engine_name,
            "archs": list(self.archs),
            "n_rounds": self.rounds,
            "pool_n": len(self.labels),
            "plan_seed": self._plan_seed,
            "scheduler": self.folds.state(),
        }

    def check_meta(self, meta: dict) -> None:
        if meta.get("archs") != list(self.archs):
            raise ValueError(f"checkpoint archs {meta.get('archs')} != "
                             f"config archs {list(self.archs)}")
        # the fold PARTITION is deterministic in (labels, K, rounds, seed):
        # a different round schedule or pool silently re-partitions the
        # data, so the restored cursor would index folds the checkpointed
        # run never saw -- refuse instead of resuming on the wrong folds
        if meta.get("n_rounds", self.rounds) != self.rounds or \
                meta.get("pool_n", len(self.labels)) != len(self.labels):
            raise ValueError(
                f"checkpoint schedule (rounds={meta.get('n_rounds')}, "
                f"pool={meta.get('pool_n')}) != config "
                f"(rounds={self.rounds}, pool={len(self.labels)}); "
                "resume needs the same fold partition -- save with the full "
                "round budget and stop early via run(until=...)")

    def load_state_dict(self, state: dict, meta: dict) -> None:
        """Takes trees of tensors or numpy arrays on any device (a restored
        checkpoint's are CPU tensors) and moves them to the population's
        device."""
        to = lambda t: torch.as_tensor(t).to(self.device)  # noqa: E731
        self.client_params = [tree_map(to, c["params"])
                              for c in state["clients"]]
        self.client_opts = [tree_map(to, c["opt"]) for c in state["clients"]]
        self._plan_seed = int(meta["plan_seed"])
        self.folds.load_state(meta["scheduler"])
