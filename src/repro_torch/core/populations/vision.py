"""Stacked-VisionNet client population -- the paper's Algorithm-1 case
study as a ``Federation`` population (``repro/core/populations/vision.py``).

K clients are a *stacked* tree (leading axis K, ``core.stacking``) and
every phase runs all K at once through ``models.visionnet``'s stacked
forward (one grouped conv per layer, ``torch.bmm`` for the dense layers):

  local phase    a loop over the fixed-shape (K, T, B) batch plan from
                 ``data.federated``; padded steps are masked out of the
                 update, as the JAX scan's ``_masked_lerp`` does
  mutual phase   per mutual epoch: the dropout-free shared predictions on
                 the public fold, then one Eq.-1 descent (BCE + kl_weight
                 x the Bernoulli Eq.-2 KLD against them, held fixed) with
                 a per-client SGD update and clip
  prediction     dropout-free stacked inference: fold scores and eval

``dispatch_log`` keeps the JAX package's (round, name) entries at the same
points (``local_scan``, ``mutual_scan``, ``accuracy_scan``, ``predict``);
here each entry marks one phase call, not one jitted program.  Losses are
reduced on the device and read once a phase.  The training pool is
uploaded to the device once and every batch is gathered there.  The
convolutions and matmuls run in full fp32 (``visionnet.strict_fp32``: no
TF32), as the JAX reference does.

Dropout draws are the port's own: the checkpoint's ``"key"`` leaf
(uint32 (2,), the JAX package's raw PRNG key) is advanced once per phase
by numpy and seeds that phase's ``torch.Generator``; each package restores
the other's checkpoints, but the masks differ.  ``device=None`` means the
CUDA device and raises without one.

The population executes ``dml`` / ``fedavg`` / ``async`` and the privacy
and robustness strategies ``dp-dml`` / ``trimmed-dml`` / ``median-dml``;
``sparse-dml`` is refused -- the VisionNet head shares Bernoulli
probabilities (one float per example), which have no top-k structure to
sparsify.  Byzantine clients, the DP release, the robust combiners and the
payload tap run the extended mutual program of the JAX package's
``_mutual_scan_ext``: per epoch the shared predictions, the senders'
poisoning, the DP release of the whole (K, B) stack (one draw an epoch,
``privacy.dp.gaussian``), then the plain epoch step or the robust one.
Without poisoning or DP the shared tensor is the plain path's, so a
tap-only run is the plain run bit for bit.

With a client mesh (``VisionClients(..., mesh=...)``, a
``sharding.ClientMesh``) and K > 1 the local and mutual phases run on the
mesh's entries (``_sharded_local_steps``, ``_sharded_mutual``): each entry
owns whole clients (round-robin spill, ``stacking.client_layout``), local
training moves nothing between entries, and the mutual phase gathers the
(K_loc, B_pub) public-fold predictions once a mutual epoch.  Both
engines draw the dropout masks at the whole fleet's shape
(``visionnet.FleetDraws``), each entry taking its clients' rows, so a
sharded session draws an unsharded one's masks.  Its rounds match the
unsharded engine's within fp32 rounding (the grouped convolutions run at
another group count), not bit for bit as the JAX package's width-2
chunks make them; the weight syncs gather the fleet to natural order
first and run the same code.  The DP, Byzantine, robust and payload-tap
features run unsharded only.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.visionnet import VisionNetConfig
from repro_torch.core import async_fl, fedavg, stacking
from repro_torch.core.distributed import value_and_grad
from repro_torch.core.mutual import (_pair_mask, bernoulli_kl_to_target,
                                     bernoulli_mutual_terms_vs,
                                     robust_bernoulli_target)
from repro_torch.core.populations.base import MeshState, Population
from repro_torch.data.federated import (FoldScheduler, NonIIDScheduler,
                                        round_batch_indices)
from repro_torch.kernels import ops
from repro_torch.models.visionnet import (FleetDraws, bce_loss,
                                          init_visionnet,
                                          shallow_deep_split, strict_fp32,
                                          visionnet_forward)
from repro_torch.optim import SGDConfig, sgd_init, sgd_update
from repro_torch.privacy import dp as dp_mod
from repro_torch.sharding import map_entries
from repro_torch.tree import tree_leaves, tree_map


def _masked_lerp(old, new, w: torch.Tensor):
    """Per client, ``new`` where the step is real (w = 1) and ``old`` where
    it is padding (w = 0): the select that the JAX package's
    ``w * new + (1 - w) * old`` is for finite values."""
    def sel(a, b):
        return torch.where(w.reshape((-1,) + (1,) * (a.dim() - 1)) > 0, b, a)
    return tree_map(sel, old, new)


def _masked_step(params, opt, grads, w: torch.Tensor, cfg: SGDConfig,
                 all_real: bool):
    """``sgd_update`` applied only to the clients where w = 1; the others'
    params and velocity ride through unchanged and their step stays."""
    new_p, new_o, _ = sgd_update(params, grads, opt, cfg)
    if all_real:
        return new_p, new_o
    return (_masked_lerp(params, new_p, w),
            {"vel": _masked_lerp(opt["vel"], new_o["vel"], w),
             "step": opt["step"] + w.to(torch.int32)})


class VisionClients(MeshState, Population):
    """K stacked VisionNet clients on a (train_images, train_labels) pool.

    The JAX constructor's signature and defaults, plus ``device``.
    ``mesh``: a ``sharding.ClientMesh`` with a ``clients`` axis -- the
    round's training phases then run on its entries (see the module
    docstring).

    ``byzantine``: ``{client_index: mode}`` marks adversarial clients --
    ``"label-flip"`` poisons their LOCAL training labels, ``"sign-flip"``
    inverts the predictions they share (p -> 1 - p), ``"collude"`` makes
    them share confident mass on the wrong public label.
    ``record_payloads`` keeps every round's on-wire prediction payloads in
    ``payload_log`` ((E, K, B) numpy each) and every round's private-fold
    indices in ``fold_log`` (the attack probes' observation tap).
    """

    engine_name = "federated"
    supported = frozenset({"dml", "fedavg", "async",
                           "dp-dml", "trimmed-dml", "median-dml"})
    _BYZ_MODES = ("label-flip", "sign-flip", "collude")

    def __init__(self, vn_cfg: VisionNetConfig, train_images: np.ndarray,
                 train_labels: np.ndarray, n_clients: int = 5,
                 rounds: int = 12, local_epochs: int = 2,
                 batch_size: int = 32, lr: float = 0.05,
                 momentum: float = 0.9, clip_norm: float = 1.0,
                 non_iid_alpha: float = 0.0, seed: int = 0,
                 eval_batch: int = 256, byzantine=None,
                 record_payloads: bool = False, mesh=None, device=None):
        axes = getattr(mesh, "axis_names", ())
        if mesh is not None and stacking.CLIENT_AXIS not in axes:
            raise ValueError(
                f"mesh needs a '{stacking.CLIENT_AXIS}' axis, got {axes}")
        self.mesh = mesh
        self.byzantine = {int(c): m for c, m in (byzantine or {}).items()}
        for c, mode in self.byzantine.items():
            if not 0 <= c < n_clients:
                raise ValueError(
                    f"byzantine client {c} out of range (K={n_clients})")
            if mode not in self._BYZ_MODES:
                raise ValueError(
                    f"unknown byzantine mode {mode!r} for client {c}; "
                    f"VisionClients supports {self._BYZ_MODES}")
        self._flip_rows = sorted(c for c, m in self.byzantine.items()
                                 if m == "label-flip")
        self.record_payloads = bool(record_payloads)
        self.payload_log: List[dict] = []
        self.fold_log: List[list] = []
        self.device = ops.resolve_device(device)
        self.vn_cfg = vn_cfg
        self.images = train_images
        self.labels = train_labels
        self.n_clients = n_clients
        self.rounds = rounds
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.eval_batch = eval_batch
        self.seed = seed
        self.sgd_cfg = SGDConfig(lr=lr, momentum=momentum,
                                 clip_norm=clip_norm)
        # the JAX package's PRNGKey(seed) data: (high, low) 32-bit words
        self.key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                            np.uint32)
        self._plan_seed = seed * 100_003 + 17
        self.dispatch_log: List[Tuple[int, str]] = []
        self._round_idx = -1                      # -1 = init phase
        # the pool, on the device once; every batch is gathered there
        self._images = torch.as_tensor(train_images, dtype=torch.float32,
                                       device=self.device)
        self._labels = torch.as_tensor(train_labels, device=self.device)
        # Algorithm 1 line 1: Fold <- (1+Clients) x Rounds + 1
        if non_iid_alpha > 0:
            self.folds = NonIIDScheduler(train_labels, n_clients, rounds,
                                         alpha=non_iid_alpha, seed=seed)
        else:
            self.folds = FoldScheduler(train_labels, n_clients, rounds,
                                       seed=seed)
        # line 3/6: global model trained on public fold
        init_gen = torch.Generator().manual_seed(self._split_key())
        self.global_params = init_visionnet(init_gen, vn_cfg, self.device)
        self.global_opt = sgd_init(self.global_params)
        self._train_single(self.folds.pop())
        # lines 7-8: clients start from G
        self.client_params = stacking.broadcast_stack(self.global_params,
                                                      n_clients)
        self.client_opts = stacking.stacked_sgd_init(self.client_params)
        self.n_params = sum(p.numel()
                            for p in tree_leaves(self.global_params))
        self.shallow_mask = shallow_deep_split(self.global_params)
        self._last_folds: Optional[list] = None

    def validate_strategy(self, strategy) -> None:
        if strategy.name == "sparse-dml":
            raise ValueError(
                "sparse-dml needs a categorical prediction space to take a "
                "top-k of; the stacked VisionNet population shares Bernoulli "
                "probabilities (one float per example).  Use DML here, or "
                "SparseDML with the hetero / LM populations.")
        super().validate_strategy(strategy)

    # -- helpers ----------------------------------------------------------
    def begin_round(self, r: int) -> None:
        self._round_idx = r

    def _next_plan_seed(self) -> int:
        self._plan_seed += 1
        return self._plan_seed

    def _split_key(self) -> int:
        """Advance ``key`` (where the JAX package splits it) and return a
        seed for the phase's generator."""
        rng = np.random.default_rng(self.key)
        self.key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
        return int(rng.integers(0, 2 ** 63))

    def _dropout_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self._split_key())

    def _batch(self, idx: np.ndarray):
        """Images and labels at ``idx`` (any shape), gathered on the device."""
        i = torch.as_tensor(idx, device=self.device)
        return self._images[i], self._labels[i]

    def _local_steps(self, params, opt, idx: np.ndarray, mask: np.ndarray,
                     flip_rows=()):
        """Every client's local epochs: a loop over the (K, T, B) plan
        ``idx``; step t updates client c only where mask[c, t] = 1; the
        labels of the clients in ``flip_rows`` are flipped (label-flip
        attackers).  Returns (params, opt, mean BCE per client (K,) on the
        device)."""
        fleet = FleetDraws(self._dropout_generator(), mask.shape[0])
        w = torch.as_tensor(mask, device=self.device)
        loss_sum = torch.zeros(mask.shape[0], device=self.device)
        with strict_fp32():
            for t, images, labels in self._plan_batches(idx, flip_rows):
                fleet.step()
                params, opt, bce = self._sgd_step(params, opt, images, labels,
                                                  fleet.rows(), w[:, t],
                                                  bool(mask[:, t].all()))
                loss_sum += bce * w[:, t]
        return params, opt, loss_sum / torch.clamp(w.sum(1), min=1.0)

    def _plan_batches(self, idx: np.ndarray, flip_rows=()):
        """(t, images, labels) of each step of the (K, T, B) plan ``idx``,
        gathered on the device, the labels of the clients in
        ``flip_rows`` flipped (label-flip attackers)."""
        for t in range(idx.shape[1]):
            images, labels = self._batch(idx[:, t])
            if flip_rows:
                labels = labels.clone()
                labels[list(flip_rows)] = 1 - labels[list(flip_rows)]
            yield t, images, labels

    def _sgd_step(self, params, opt, images, labels, gen, w: torch.Tensor,
                  all_real: bool):
        """One local SGD step of a client stack on its batch, applied where
        w = 1: (params, opt, BCE per client)."""
        def loss_fn(q):
            probs = visionnet_forward(q, self.vn_cfg, images, train=True,
                                      generator=gen)
            bce = bce_loss(probs, labels)
            return torch.sum(bce), bce.detach()

        _, bce, grads = value_and_grad(loss_fn, params)
        params, opt = _masked_step(params, opt, grads, w, self.sgd_cfg,
                                   all_real)
        return params, opt, bce

    def _train_single(self, fold: np.ndarray) -> float:
        """Global-model training = the same local steps with K = 1."""
        idx, mask = round_batch_indices([fold], self.local_epochs,
                                        self.batch_size,
                                        seed=self._next_plan_seed())
        if idx.shape[1] == 0:
            return 0.0
        gp, go, losses = self._local_steps(
            stacking.expand_stack(self.global_params),
            stacking.expand_stack(self.global_opt), idx, mask)
        self.dispatch_log.append((self._round_idx, "local_scan"))
        self.global_params = stacking.client_slice(gp, 0)
        self.global_opt = stacking.client_slice(go, 0)
        return float(losses[0])

    def _local_round(self, part_mask: Optional[np.ndarray] = None):
        """Pop K client folds and run every client's local epochs.  Returns
        (folds, per-client mean loss).  ``part_mask`` (K,) 0/1 zeroes the
        whole batch plan of absent clients."""
        K = self.n_clients
        folds, idx, mask = self.folds.pop_round(
            K, self.local_epochs, self.batch_size,
            seed=self._next_plan_seed())
        if idx.shape[1] == 0:
            return folds, [0.0] * K
        if part_mask is not None:
            mask = mask * part_mask[:, None]
        if self.mesh is not None and K > 1:
            losses = self._sharded_local_steps(idx, mask, self._flip_rows)
        else:
            self.client_params, self.client_opts, losses = \
                self._local_steps(self.client_params, self.client_opts, idx,
                                  mask, self._flip_rows)
        self.dispatch_log.append((self._round_idx, "local_scan"))
        return folds, losses.tolist()

    # -- the client mesh ---------------------------------------------------
    def _entry_layout(self):
        """Per entry: the natural client of each slot (a dummy wraps to a
        real one) and a (K_loc,) 0/1 float of its real slots."""
        n = self.mesh.shape[stacking.CLIENT_AXIS]
        rows = stacking.entry_rows(self.n_clients, n)
        real = [(stacking.local_client_ids(self.n_clients, n, d)
                 < self.n_clients).float() for d in range(n)]
        return rows, real

    def _gather_losses(self, per_entry) -> torch.Tensor:
        n = self.mesh.shape[stacking.CLIENT_AXIS]
        return stacking.gather_clients(per_entry, self.n_clients, n,
                                       self.device)[:self.n_clients]

    def _sharded_local_steps(self, idx: np.ndarray, mask: np.ndarray,
                             flip_rows=()) -> torch.Tensor:
        """``_local_steps`` on the mesh's entries, each training only its
        own clients on their own batches: no tensor crosses between
        entries.  Dummy slots sit the phase out, so they keep the state of
        the client they re-host.  Returns the mean BCE per client (K,) on
        ``self.device``."""
        params, opts = self._to_mesh()
        rows, real = self._entry_layout()
        fleet = FleetDraws(self._dropout_generator(), self.n_clients)
        w_np = [mask[r] * m.numpy()[:, None] for r, m in zip(rows, real)]
        w = [torch.as_tensor(x, device=dev)
             for x, dev in zip(w_np, self.mesh.devices)]
        loss_sum = [torch.zeros(x.shape[0], device=dev)
                    for x, dev in zip(w_np, self.mesh.devices)]
        t = images = labels = None

        def one(d, dev, p, o):
            r = torch.as_tensor(rows[d], device=images.device)
            params[d], opts[d], bce = self._sgd_step(
                p, o, images.index_select(0, r).to(dev),
                labels.index_select(0, r).to(dev), fleet.rows(rows[d]),
                w[d][:, t], bool(w_np[d][:, t].all()))
            loss_sum[d] += bce * w[d][:, t]

        with strict_fp32():
            for t, images, labels in self._plan_batches(idx, flip_rows):
                fleet.step()
                map_entries(self.mesh, one, list(params), list(opts))
        return self._gather_losses(
            [s / torch.clamp(x.sum(1), min=1.0) for s, x in zip(loss_sum, w)])

    def _sharded_mutual(self, images, labels, pm, kl_weight: float,
                        mutual_epochs: int):
        """The mutual epochs on the mesh's entries.  Per epoch each entry
        predicts its own clients on the public fold; the (K_loc, B_pub)
        predictions are gathered (the one cross-entry tensor of the round),
        put back in natural order and cut to K, and each entry descends
        Eq. 1 for its clients only, under its rows of ``_pair_mask(K,
        pm)``; dummies are masked out of the average and the update.
        Returns the last epoch's (bce, kld), each (K,)."""
        K, n = self.n_clients, self.mesh.shape[stacking.CLIENT_AXIS]
        params, opts = self._to_mesh()
        rows, real = self._entry_layout()
        fleet = FleetDraws(self._dropout_generator(), K)
        pmt, pair = (torch.as_tensor(pm, dtype=torch.float32),
                     _pair_mask(K, pm))
        pm_loc, pair_rows = [], []
        for d, m in enumerate(real):
            safe = torch.clamp(stacking.local_client_ids(K, n, d), max=K - 1)
            pm_loc.append(pmt[safe] * m)
            pair_rows.append(pair[safe] * m[:, None])
        on = [(images.to(dev), labels.to(dev)) for dev in self.mesh.devices]
        for _ in range(mutual_epochs):
            shared_loc = map_entries(
                self.mesh, lambda d, dev, p: self._predict(p, on[d][0]),
                params)
            shared = {dev: stacking.gather_clients(shared_loc, K, n, dev)[:K]
                      for dev in set(self.mesh.devices)}
            fleet.step()
            out = map_entries(
                self.mesh, lambda d, dev, p, o: self._epoch_step(
                    p, o, *on[d], fleet.rows(rows[d]), pm_loc[d].to(dev),
                    kl_weight, bool(pm_loc[d].all()), shared[dev],
                    pair_rows[d].to(dev)), list(params), list(opts))
            for d, (p, o, _, _) in enumerate(out):
                params[d], opts[d] = p, o
        return (self._gather_losses([o[2] for o in out]),
                self._gather_losses([o[3] for o in out]))

    @torch.no_grad()
    def _predict(self, stacked_params, images) -> torch.Tensor:
        with strict_fp32():
            return visionnet_forward(stacked_params, self.vn_cfg, images)

    def _fold_accuracies(self, folds) -> List[float]:
        """Each client scored on its OWN fold, over a padded (K, N) stack
        (the async baseline's weighting metric)."""
        n = max(max((len(f) for f in folds), default=0), 1)
        K = len(folds)
        idx = np.zeros((K, n), np.int64)
        mask = np.zeros((K, n), np.float32)
        for c, f in enumerate(folds):
            idx[c, :len(f)] = f
            mask[c, :len(f)] = 1.0
        images, labels = self._batch(idx)
        probs = self._predict(self.client_params, images)
        hit = ((probs > 0.5) == (labels > 0.5)).float()
        m = torch.as_tensor(mask, device=self.device)
        acc = torch.sum(hit * m, dim=1) / torch.clamp(m.sum(1), min=1.0)
        self.dispatch_log.append((self._round_idx, "accuracy_scan"))
        return acc.tolist()

    def _accuracy_chunked(self, stacked_params, images: torch.Tensor,
                          labels: torch.Tensor) -> np.ndarray:
        """All clients' accuracy on a SHARED dataset (on the device),
        eval_batch examples at a time.  Returns (K,)."""
        K = tree_leaves(stacked_params)[0].shape[0]
        correct = torch.zeros((K,), dtype=torch.int64, device=self.device)
        for i in range(0, len(images), self.eval_batch):
            probs = self._predict(stacked_params,
                                  images[i:i + self.eval_batch])
            self.dispatch_log.append((self._round_idx, "predict"))
            correct += torch.sum(
                (probs > 0.5) == (labels[None, i:i + self.eval_batch] > 0.5),
                dim=1)
        return correct.cpu().numpy() / len(images)

    # -- strategy capabilities --------------------------------------------
    def local_phase(self, r: int, part: List[int], pm) -> List[float]:
        K = self.n_clients
        folds, losses = self._local_round(pm if len(part) < K else None)
        self._last_folds = folds
        if self.record_payloads:
            # per-client private-fold indices: the attack probes' member
            # ground truth (indices only; the pool itself is not copied)
            self.fold_log.append([np.asarray(f) for f in folds])
        return losses

    def public_payload(self, r: int):
        # public fold: rotating common test set from the server
        return self.folds.pop()

    def weights_payload(self, r: int):
        return self.folds.pop()

    def _byz_payload_masks(self) -> Tuple[np.ndarray, np.ndarray]:
        sf = np.zeros((self.n_clients,), np.float32)
        cl = np.zeros((self.n_clients,), np.float32)
        for c, mode in self.byzantine.items():
            if mode == "sign-flip":
                sf[c] = 1.0
            elif mode == "collude":
                cl[c] = 1.0
        return sf, cl

    def _epoch_step(self, params, opt, images, labels, gen, pmt, kl_weight,
                    full: bool, shared, pair_w, target=None):
        """One Eq.-1 descent of every client against FIXED received
        predictions: the Eq.-2 mean against ``shared`` (K, B) under
        ``pair_w`` or, given a robust ``target`` (K, B), the Bernoulli KL
        to each client's own target row, absentees at zero KL weight.
        Updates only the participants.  Returns (params, opt, bce, kld)."""
        def loss_fn(q):
            live = visionnet_forward(q, self.vn_cfg, images, train=True,
                                     generator=gen)
            bce = bce_loss(live, labels)
            if target is None:
                kld = torch.mean(
                    bernoulli_mutual_terms_vs(live, shared, pair_w), dim=-1)
            else:
                kld = torch.mean(bernoulli_kl_to_target(live, target),
                                 dim=-1) * pmt
            return (torch.sum(bce * pmt) + kl_weight * torch.sum(kld),
                    (bce.detach(), kld.detach()))

        with strict_fp32():
            _, (bce, kld), grads = value_and_grad(loss_fn, params)
            params, opt = _masked_step(params, opt, grads, pmt, self.sgd_cfg,
                                       full)
        return params, opt, bce, kld

    def mutual_phase(self, r, part, pm, payload, kl_weight, mutual_epochs,
                     sparse_k: int = 0, dp=None, robust=None) -> dict:
        K = self.n_clients
        pub = payload.data
        out = {"ran": False, "positions": len(pub)}
        sf, cl = self._byz_payload_masks()
        poison = bool(sf.any() or cl.any())
        if self.mesh is not None and (dp is not None or robust is not None
                                      or poison or self.record_payloads):
            raise NotImplementedError(
                "DP / Byzantine / robust-combine / payload recording run "
                "on the unsharded engine only; drop mesh= or the feature")
        if mutual_epochs > 0 and len(part) >= 2 and self.mesh is not None \
                and K > 1:
            images, labels = self._batch(pub)
            bce, kld = self._sharded_mutual(images, labels, pm, kl_weight,
                                            mutual_epochs)
            self.dispatch_log.append((r, "mutual_scan"))
            loss, kld = torch.stack([bce + kl_weight * kld, kld]).tolist()
            out = {"ran": True, "positions": len(pub),
                   "client_loss": [x * m for x, m in zip(loss, pm)],
                   "kl_loss": kld}
        elif mutual_epochs > 0 and len(part) >= 2:
            images, labels = self._batch(pub)
            fleet = FleetDraws(self._dropout_generator(), K)
            pmt = torch.as_tensor(pm, dtype=torch.float32,
                                  device=self.device)
            pair_w = _pair_mask(K, pm, device=self.device)
            if poison:
                sft, clt = (torch.as_tensor(m, device=self.device)[:, None]
                            for m in (sf, cl))
                wrong = torch.clamp(1.0 - labels.float(), 0.02,
                                    0.98)[None, :]
            params, opt = self.client_params, self.client_opts
            sent = []
            for e in range(mutual_epochs):
                # what goes over the wire: dropout-free, held fixed
                shared = self._predict(params, images)
                if poison:
                    # Byzantine senders replace what they SEND; their own
                    # training still sees honest receipts
                    shared = ((1.0 - sft - clt) * shared
                              + sft * (1.0 - shared) + clt * wrong)
                if dp is not None:
                    noise = dp_mod.gaussian(dp.keys[e], shared.shape,
                                            self.device)
                    shared = dp_mod.dp_probs_payload(
                        shared, dp.clip, dp.noise_multiplier, noise)
                if self.record_payloads:
                    sent.append(shared)
                target = None if robust is None else \
                    robust_bernoulli_target(shared, pm, *robust)
                fleet.step()
                params, opt, bce, kld = self._epoch_step(
                    params, opt, images, labels, fleet.rows(), pmt, kl_weight,
                    len(part) == K, shared, pair_w, target)
            self.client_params, self.client_opts = params, opt
            if self.record_payloads:
                self.payload_log.append(
                    {"round": r, "public": np.asarray(pub),
                     "payloads": torch.stack(sent).cpu().numpy()})
            self.dispatch_log.append((r, "mutual_scan"))
            loss, kld = torch.stack([bce + kl_weight * kld, kld]).tolist()
            out = {"ran": True, "positions": len(pub),
                   "client_loss": [x * m for x, m in zip(loss, pm)],
                   "kl_loss": kld}
        return out

    def fedavg_combine(self, part: List[int], pm) -> None:
        self._gather_clients_host()
        if len(part) == self.n_clients:
            self.client_params = fedavg.average_weights(self.client_params)
            avg = self.client_params
        else:
            # server averages the M participants; only they receive the
            # broadcast back (absentees are offline this round)
            avg = fedavg.weighted_average_weights(self.client_params, pm)
            self.client_params = stacking.client_lerp(self.client_params,
                                                      avg, pm)
        self.global_params = stacking.client_slice(avg, 0)

    def async_combine(self, r, part, pm, delta, min_round, pub) -> str:
        self._gather_clients_host()
        scores = self._fold_accuracies(self._last_folds)
        # absentees contribute no weight to the aggregate and receive none
        # of it back (scores masked -> their average weight is 0)
        synced, layer = async_fl.async_round_update(
            self.client_params, np.asarray(scores) * pm, self.shallow_mask,
            r, delta, min_round)
        # Algorithm 1 lines 17-18: G takes the aggregate then trains on a
        # fold -- sliced from the SYNCED tree, where every client received
        # the round's average
        self.global_params = stacking.client_slice(synced, 0)
        if len(part) < self.n_clients:
            synced = stacking.client_lerp(self.client_params, synced, pm)
        self.client_params = synced
        self._train_single(pub)
        return layer

    def async_param_counts(self):
        return async_fl.count_params_by_mask(self.global_params,
                                             self.shallow_mask)

    @property
    def params_per_client(self) -> int:
        return self.n_params

    # -- final eval (paper Table II / Fig. 3) ------------------------------
    def evaluate(self, history, split=None):
        if split is None:
            raise ValueError(
                "the stacked VisionNet population scores clients on a "
                "held-out dataset: evaluate(split=(test_images, "
                "test_labels))")
        self._round_idx = self.rounds                  # eval phase
        self._gather_clients_host()
        images = torch.as_tensor(split[0], dtype=torch.float32,
                                 device=self.device)
        labels = torch.as_tensor(split[1], device=self.device)
        history.client_test_acc = [
            float(a) for a in self._accuracy_chunked(self.client_params,
                                                     images, labels)]
        gp = stacking.expand_stack(self.global_params)
        history.global_test_acc = float(
            self._accuracy_chunked(gp, images, labels)[0])
        return history

    # -- checkpoint/resume -------------------------------------------------
    def state_dict(self) -> dict:
        return {"client_params": self.client_params,
                "client_opts": self.client_opts,
                "global_params": self.global_params,
                "global_opt": self.global_opt,
                "key": torch.from_numpy(self.key.copy())}

    def meta_dict(self) -> dict:
        return {"engine": self.engine_name,
                "n_clients": self.n_clients,
                "n_rounds": self.rounds,
                "pool_n": len(self.labels),
                "plan_seed": self._plan_seed,
                "scheduler": self.folds.state()}

    def check_meta(self, meta: dict) -> None:
        if meta.get("n_clients") != self.n_clients:
            raise ValueError(
                f"checkpoint K={meta.get('n_clients')} != config "
                f"K={self.n_clients}")
        # fold partition is deterministic in (labels, K, rounds, seed); a
        # different schedule/pool would silently resume on the wrong folds
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
        checkpoint's are CPU tensors, the JAX package's numpy arrays) and
        moves them to the population's device."""
        to = lambda t: torch.as_tensor(t).to(self.device)  # noqa: E731
        self._entries = None
        self.client_params = tree_map(to, state["client_params"])
        self.client_opts = tree_map(to, state["client_opts"])
        self.global_params = tree_map(to, state["global_params"])
        self.global_opt = tree_map(to, state["global_opt"])
        key = state["key"]
        if isinstance(key, torch.Tensor):
            key = key.cpu().numpy()
        self.key = np.array(key, dtype=np.uint32).reshape(2)
        self._plan_seed = int(meta["plan_seed"])
        self.folds.load_state(meta["scheduler"])
