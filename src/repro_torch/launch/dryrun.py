"""Dry-run of the port: build every (arch x shape x mesh x method) on
PyTorch's meta device, allocating nothing, and count what eager PyTorch
dispatches, for the roofline report (the port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \
      --out build/dryrun/single.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \
      --shape train_4k --mesh clients --method dml
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod \
      --out build/dryrun/pod.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
      --shape train_4k --mesh multi --method dml      # clients = pods
  PYTHONPATH=src python -m repro_torch.analysis.roofline build/dryrun/*.jsonl

It runs on any machine: the meta device has shapes and dtypes but no
storage, so a full-size step costs host time only.

How the counts differ from the JAX dry-run's:
  - JAX lowers and compiles each case on placeholder devices and reads
    XLA's cost and memory analysis.  Here the port's own step functions
    (``launch/steps.py``, ``core/distributed.py``) run eagerly on meta
    tensors under ``count()``.  There is no HLO, so nothing is parsed.
  - Eager dispatch sees every layer, so no depth correction is needed.
  - ``flops`` are ``torch.utils.flop_counter``'s: matmul-, conv- and
    attention-class ops only.  XLA also counts elementwise work, so the
    port's ``useful_flop_ratio`` is not comparable with the JAX records.
  - ``bytes`` are every aten op's input bytes plus output bytes (views
    count 0): an unfused analogue of XLA's "bytes accessed", which a
    fused program undercuts.
  - ``argument_bytes`` are the storages the program reads but did not
    make, ``output_bytes`` those it made that are alive when it returns,
    ``temp_bytes`` the peak of the live storages it made, less the
    outputs; ``peak_bytes`` is their sum.  The step functions update the
    params and moments in place, so the outputs are the new tensors only.
  - Every kernel runs through its plain version (impl "ref"), as the JAX
    baseline runs at its default impl: the hand-written kernels' own work
    is not counted yet.
  - On the ``single`` and ``clients`` meshes collectives are computed
    from shapes: the public logits the clients exchange
    (``distributed.comm_bytes``; SparseDML's top-k sets by
    ``mutual.sparse_share_bytes``) for ``dml`` and ``mutual``, the
    parameter average for ``fedavg_sync``, none for ``standard``.  On the
    ``pod`` and ``multi`` meshes they are counted: see below.

Meshes: ``single`` is one card (every client of a client method on it, so
nothing crosses a link: ``collectives["total"]`` is 0 and
``"client_axis"`` says what would cross one).  ``clients`` puts one client
on each card, as the client mesh (``sharding.ClientMesh``) runs
``make_sharded_dml_step``: the clients' work is alike, so a card's counts
are the program's over the client count, and ``t_collective`` is a card's
share of the exchanged bytes at the link rate.

``pod`` and ``multi`` are JAX's production meshes (its ``single`` and
``multi``; the port's ``single`` is one card): data 16 x model 16 = 256
cards, and pod 2 x 16 x 16 = 512.  Each case runs in this one process on
PyTorch's fake process group of that world size, as rank 0 of a named
DeviceMesh (``launch.mesh.make_production_mesh``): its arguments are
DTensors of meta shards placed by their logical axes (``_shardings``;
``launch.specs``' ``*_axes``), and the step runs under
``sharding.use_mesh`` with ``run_case``'s axis rules, as JAX's
``jax.jit(step, in_shardings=...)`` under ``use_mesh``.  ``count(sharded=
True)`` then counts one card: it defers every DTensor-level op (returns
``NotImplemented``, so DTensor propagates the sharding), counts the local
aten ops that DTensor runs on the rank's shards (FLOPs by
``torch.utils.flop_counter``'s registry at the local shapes, bytes and
live memory as above), skips the ``FakeTensor`` ops of DTensor's sharding
propagation, and sums the bytes each ``_c10d_functional`` collective
writes, by kind and by mesh axis: ``collectives`` holds ``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``count``, ``total``,
``cross_pod`` and ``pod_axis`` as JAX's ``collective_stats`` reports
them, and ``by_axis`` (each mesh axis's, or flattened run of axes', bytes
by kind and count).  The DML cases put the client axis on ``pod``
(``spmd_client_axis="pod"``), as JAX's do.

Not ported, and why: ``collective_stats``, ``_parse_groups``,
``_pod_class``, ``_type_bytes`` and ``cost_dict`` parse HLO (the
collectives are counted at dispatch instead); ``depth_corrected_costs``
corrects XLA's once-counted scan body, and eager dispatch counts every
layer.  Of the variants, ``flash`` (the ``xla_flash`` impl) is out by
design and refused; ``attn_dp``, ``no_fsdp`` and ``seqpar`` are axis
rules, which change the ``pod`` and ``multi`` programs and nothing on one
card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import sharding as shd
from repro_torch.analysis.roofline import MESH_KINDS, roofline_terms
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import distributed as dml
from repro_torch.core.mutual import sparse_share_bytes
from repro_torch.launch import specs as S
from repro_torch.launch.steps import (decode_window, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.optim import AdamWConfig

METHODS = ("standard", "dml", "mutual", "fedavg_sync")
N_CLIENTS = 2
SPARSE_K = 64
VARIANTS = ("baseline", "chunked_ce", "noremat", "slotremat", "sparse",
            "attn_dp", "no_fsdp", "seqpar")
REFUSED = {
    "flash": "the xla_flash impl is not ported (by design): the port's "
             "flash attention is the hand-written kernel, impl 'cuda'",
}
# the data x model meshes: world size and multi_pod
PRODUCTION = {"pod": (256, False), "multi": (512, True)}
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "all_reduce": "all-reduce",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}


# ---------------------------------------------------------------------------
# the counter

@dataclass
class Counts:
    """What ``count()`` saw: FLOPs, op bytes and the memory of the program
    (see the module docstring)."""
    flops: int = 0
    bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    collectives: Dict[str, Any] = None

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes


def _fake(ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in ts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts op bytes and follows storages: one made inside is live until
    its storage dies (a ``weakref.finalize`` on the storage, whose Python
    object lives as long as the storage does)."""

    def __init__(self, counts: Counts, axis_of=None):
        super().__init__()
        self.counts = counts
        # sharded: {process group name: mesh axis name}; None on one card
        self.axis_of = axis_of
        # live storages by key (a key is reused once its storage dies, so
        # each leaves its dict when it dies): read but not made here, and
        # made here
        self.args: Dict[int, int] = {}
        self.live: Dict[int, int] = {}
        self.arg_bytes = 0
        self.now = 0
        self.peak = 0

    @staticmethod
    def _check(func, t: torch.Tensor) -> None:
        # a 0-d CPU tensor is a host scalar, which PyTorch admits into
        # device ops, and an empty one holds no data (checkpoint's dummy
        # input); anything else off the meta device would be real work
        if not t.is_meta and not (t.device.type == "cpu"
                                  and (t.dim() == 0 or t.numel() == 0)):
            raise RuntimeError(
                f"dry-run: {func} saw a tensor on {t.device}; every tensor "
                "of a dry-run must be on the meta device")

    def _release(self, key: int) -> None:
        self.now -= self.live.pop(key)

    def _release_arg(self, key: int) -> None:
        del self.args[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in _pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if self.axis_of is not None:
            if any(isinstance(t, DTensor) for t in ins):
                return NotImplemented        # DTensor runs the local ops
            if _fake(ins) or (ins and not any(t.is_meta for t in ins)):
                # sharding propagation, and DTensor's own host
                # bookkeeping (shard offsets): no card runs these
                return func(*args, **kwargs)
        for t in ins:
            self._check(func, t)
            if t.is_meta:
                storage = t.untyped_storage()
                key = storage._cdata
                if key not in self.live and key not in self.args:
                    self.args[key] = storage.nbytes()
                    self.arg_bytes += storage.nbytes()
                    weakref.finalize(storage, self._release_arg, key)
        out = func(*args, **kwargs)
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.axis_of is not None and (_fake(outs) or (
                not ins and not any(t.is_meta for t in outs))):
            return out                      # as above
        for t in outs:
            self._check(func, t)
        if not func.is_view:
            self.counts.bytes += sum(_nbytes(t) for t in ins + outs)
        if self.axis_of is not None:
            self._sharded(func, args, kwargs, outs)
        for t in outs:
            if not t.is_meta:
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self.live or key in self.args:
                continue
            self.live[key] = storage.nbytes()
            self.now += self.live[key]
            self.peak = max(self.peak, self.now)
            weakref.finalize(storage, self._release, key)
        return out

    def _sharded(self, func, args, kwargs, outs) -> None:
        """FLOPs of a local op at its local shapes, and a collective's
        bytes (the tensor it writes, as XLA's result type) by kind and
        mesh axis."""
        packet = func._overloadpacket
        if packet in flop_registry:
            self.counts.flops += flop_registry[packet](*args, **kwargs,
                                                       out_val=outs[0])
        ns = func.namespace if hasattr(func, "namespace") else ""
        kind = COLLECTIVE_KINDS.get(packet.__name__)
        if ns != "_c10d_functional" or kind is None:
            return
        c = self.counts.collectives
        b = sum(_nbytes(t) for t in outs)
        axis = self.axis_of.get(args[-1], str(args[-1]))
        c[kind] += b
        c["count"] += 1
        per = c["by_axis"].setdefault(axis, {"count": 0})
        per[kind] = per.get(kind, 0) + b
        per["count"] += 1
        if "pod" in axis.split("_"):      # its groups span the pods
            c["cross_pod"] += b
            if axis == "pod":               # ... and vary in pod alone
                c["pod_axis"] += b

    def finish(self) -> None:
        c = self.counts
        c.argument_bytes = self.arg_bytes
        c.output_bytes = self.now
        c.temp_bytes = self.peak - self.now
        if c.collectives is not None:
            c.collectives["total"] = sum(c.collectives[k] for k in
                                         COLLECTIVE_KINDS.values())


def _collectives0() -> Dict[str, Any]:
    return {**{k: 0 for k in COLLECTIVE_KINDS.values()}, "count": 0,
            "total": 0, "cross_pod": 0, "pod_axis": 0, "by_axis": {}}


@contextlib.contextmanager
def count(mesh=None):
    """Count the ops run inside: ``with count() as c: step(*args)``, then
    ``c.flops``, ``c.bytes`` and the byte fields.  FLOPs are those of a
    ``FlopCounterMode`` over the same ops.  Raises if an op sees a tensor
    that is not on the meta device (0-d and empty CPU tensors aside): a
    dry-run never computes by accident.

    With a DeviceMesh the program is sharded and one card is counted (the
    module docstring): the local ops' FLOPs, bytes and memory, and
    ``c.collectives``."""
    counts = Counts()
    if mesh is None:
        counter = _Counter(counts)
        flops = FlopCounterMode(display=False)
        with counter, flops:
            yield counts
        counts.flops = flops.get_total_flops()
    else:
        from repro_torch.launch.mesh import flat_dims
        names = list(mesh.mesh_dim_names)
        names += ["_".join(d) for d in flat_dims(mesh)]
        counts.collectives = _collectives0()
        counter = _Counter(counts, {mesh[n].get_group().group_name: n
                                    for n in names})
        with counter:
            yield counts
    counter.finish()


# ---------------------------------------------------------------------------
# case builders: return (fn, args), run as fn(*args) under count()

def _host_step(opt: Dict[str, Any]) -> Dict[str, Any]:
    """The AdamW state with its step a host int: ``adamw_update`` takes
    one, and a meta step cannot be read (the numbers do not change)."""
    return {**opt, "step": 0}


def _case_train(cfg, shape, ce_impl="dense", remat=True, slot_remat=False):
    step = make_train_step(cfg, AdamWConfig(), remat=remat, ce_impl=ce_impl,
                           slot_remat=slot_remat, impl="ref")
    params = S.model_state_specs(cfg)
    batch = S.batch_inputs(cfg, shape)
    args = [params, _host_step(S.opt_state_specs(params)), batch["tokens"]]
    if cfg.prefix_tokens:
        args.append(batch["prefix"])
    return step, tuple(args)


def _case_prefill(cfg, shape):
    step = make_prefill_step(cfg, max_seq=shape.seq_len,
                             window=decode_window(cfg, shape), impl="ref")
    batch = S.batch_inputs(cfg, shape)
    args = [S.model_state_specs(cfg), batch["tokens"]]
    if cfg.prefix_tokens:
        args.append(batch["prefix"])
    return step, tuple(args)


def _case_decode(cfg, shape):
    step = make_decode_step(cfg, window=decode_window(cfg, shape))
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device=S.META)
    # the last position of the shape: the cache is full (the ring wraps)
    return step, (S.model_state_specs(cfg), token, S.cache_specs(cfg, shape),
                  shape.seq_len - 1)


def public_batch(shape, n_clients: int = N_CLIENTS) -> int:
    """JAX's ``_case_dml`` public batch: a quarter of a client's batch."""
    return max(1, shape.global_batch // (4 * n_clients))


def dml_case(cfg, n_clients: int, batch: int, public: int, seq: int, *,
             fused: bool = True, sparse_k: int = 0, opt_cfg=None,
             kl_weight: float = 1.0, device=S.META, spmd_client_axis=None):
    """(fn, args) of one client-stacked DML step (``fused``: private CE +
    Eq. 1, ``make_dml_train_step``; else Eq. 1 alone, ``make_mutual_step``)
    of ``n_clients`` clients, ``batch`` private and ``public`` shared
    sequences of ``seq`` tokens, at impl "ref".  On the meta device
    nothing is drawn; elsewhere the params are drawn from seed 0 and the
    tokens are zeros, so that the same program runs on a card.
    ``spmd_client_axis`` as in the step factories (a data x model mesh)."""
    opt_cfg = opt_cfg or AdamWConfig()
    kw = dict(kl_weight=kl_weight, sparse_k=sparse_k, impl="ref",
              spmd_client_axis=spmd_client_axis)
    if fused:
        step = dml.make_dml_train_step(cfg, opt_cfg, **kw)
    else:
        step = dml.make_mutual_step(cfg, opt_cfg, **kw)
    params = dml.stacked_init(0, cfg, n_clients, device=device)
    opt = _host_step(dml.stacked_adamw_init(params))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    P, pd = cfg.prefix_tokens, cfg.prefix_dim
    pub_tokens = zeros((public, seq), torch.int32)
    pub_prefix = zeros((public, P, pd), cfg.cdtype()) if P else None
    if not fused:
        return step, (params, opt, pub_tokens, pub_prefix)
    tokens = zeros((n_clients, batch, seq), torch.int32)
    prefix = zeros((n_clients, batch, P, pd), cfg.cdtype()) if P else None
    return step, (params, opt, tokens, pub_tokens, prefix, pub_prefix)


def _case_dml(cfg, shape, fused=True, sparse_k=0, spmd_client_axis=None):
    """The paper's technique: N_CLIENTS clients share the global batch."""
    if shape.global_batch % N_CLIENTS:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {N_CLIENTS} clients")
    return dml_case(cfg, N_CLIENTS, shape.global_batch // N_CLIENTS,
                    public_batch(shape), S.token_len(cfg, shape),
                    fused=fused, sparse_k=sparse_k,
                    spmd_client_axis=spmd_client_axis)


def _case_fedavg_sync(cfg):
    """Baseline: the parameter average over the client axis."""
    return dml.fedavg_sync, (S.model_state_specs(cfg, N_CLIENTS),)


def check_variant(variant: str) -> Tuple[str, ...]:
    """The variant's parts ("chunked_ce+noremat"); raises on a refused or
    unknown one."""
    parts = tuple(variant.split("+"))
    for v in parts:
        if v in REFUSED:
            raise ValueError(f"variant {v!r} refused: {REFUSED[v]}")
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; known: {VARIANTS}")
    return parts


def check_mesh(mesh_kind: str, method: str) -> None:
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"unknown mesh {mesh_kind!r}; the port has "
                         f"{MESH_KINDS}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    if mesh_kind == "clients" and method == "standard":
        raise ValueError("the clients mesh puts one client on each card; a "
                         "standard step has no clients")


def build_case(cfg, shape, mesh_kind: str, method: str,
               variant: str = "baseline"):
    """(fn, args) of one case on the meta device, run as ``fn(*args)``.
    The mesh kind does not change the program (see the module
    docstring); it is checked here."""
    check_mesh(mesh_kind, method)
    parts = check_variant(variant)
    if method == "standard":
        if shape.kind == "train":
            return _case_train(cfg, shape,
                               "chunked" if "chunked_ce" in parts else "dense",
                               "noremat" not in parts, "slotremat" in parts)
        if shape.kind == "prefill":
            return _case_prefill(cfg, shape)
        return _case_decode(cfg, shape)
    sparse_k = SPARSE_K if "sparse" in parts else 0
    if method in ("dml", "mutual"):
        # JAX's DML cases hold the client axis on the pod axis of a data x
        # model mesh (a no-op where there is none)
        axis = "pod" if mesh_kind in PRODUCTION else None
        return _case_dml(cfg, shape, fused=method == "dml", sparse_k=sparse_k,
                         spmd_client_axis=axis)
    return _case_fedavg_sync(cfg)


def case_axes(cfg, shape, method: str) -> tuple:
    """The logical axes of ``build_case``'s arguments, in their order
    (None for an argument that is not a tensor): the JAX dry-run's
    in_shardings before ``_shardings`` maps them."""
    if method == "fedavg_sync":
        return (S.model_state_axes(cfg, N_CLIENTS),)
    if method in ("dml", "mutual"):
        p = S.model_state_axes(cfg, N_CLIENTS)
        b, pub = S.batch_axes(cfg, N_CLIENTS), S.public_axes(cfg)
        head = (p, S.opt_logical_axes(p))
        if method == "mutual":
            return head + (pub["public_tokens"], pub.get("public_prefix"))
        return head + (b["tokens"], pub["public_tokens"], b.get("prefix"),
                       pub.get("public_prefix"))
    p = S.model_state_axes(cfg)
    b = S.batch_axes(cfg)
    if shape.kind == "decode":
        return (p, ("batch", None), S.cache_axes(cfg), None)
    lead = (p, S.opt_logical_axes(p)) if shape.kind == "train" else (p,)
    return lead + (b["tokens"],) + ((b["prefix"],) if cfg.prefix_tokens
                                    else ())


def _shardings(args, axes, mesh) -> tuple:
    """``args`` as DTensors of meta shards placed by ``axes`` on ``mesh``
    (JAX's ``_shardings`` and ``in_shardings`` in one): a tree whose leaf
    is not a tensor (the host step, a position) passes through."""
    return tuple(a if ax is None or a is None else
                 shd.distribute_tree(a, ax, mesh)
                 for a, ax in zip(args, axes))


def mesh_rules(method: str, variant: str = "baseline") -> Dict[str, Any]:
    """``run_case``'s axis rules (``repro/launch/dryrun.py:375-385``): the
    client methods give the pod axis to the clients, and the variants
    remap attention's batch, the params' FSDP axis and the residual
    stream's sequence."""
    rules: Dict[str, Any] = ({"batch": ("data",), "attn_batch": ("data",)}
                             if method in ("dml", "mutual", "fedavg_sync")
                             else {})
    parts = check_variant(variant)
    if "attn_dp" in parts:
        rules["attn_batch"] = (rules.get("attn_batch", ("pod", "data"))
                               + ("model",))
    if "no_fsdp" in parts:
        rules["embed"] = None
    if "seqpar" in parts:
        rules["res_seq"] = "model"
    return rules


def fake_world(n: int) -> None:
    """This process as rank 0 of PyTorch's fake process group of ``n``
    ranks (collectives do nothing; meta tensors carry the shapes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(mesh_kind: str):
    """The ``pod`` or ``multi`` DeviceMesh on the fake process group."""
    from repro_torch.launch.mesh import make_production_mesh
    n, multi = PRODUCTION[mesh_kind]
    fake_world(n)
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def count_sharded(fn, args, axes, mesh, rules=None) -> Counts:
    """One card's counts of ``fn(*args)`` with ``args`` placed by ``axes``
    on ``mesh`` and the step run under ``use_mesh`` and ``rules``."""
    with shd.axis_rules(rules or {}):
        dargs = _shardings(args, axes, mesh)
        del args
        with shd.use_mesh(mesh), count(mesh) as c:
            out = fn(*dargs)       # alive at the count's end: the outputs
        del out, dargs
    return c


# ---------------------------------------------------------------------------

def collectives(cfg, shape, mesh_kind: str, method: str,
                variant: str = "baseline") -> Dict[str, float]:
    """Bytes between clients, from shapes: ``client_axis`` is what the
    round exchanges over all clients (up and down), ``total`` a card's
    share of it on the clients mesh (0 on one card)."""
    if method == "standard":
        client = 0
    elif method == "fedavg_sync":
        client = dml.comm_bytes(cfg, N_CLIENTS, 0)["fedavg_round"]
    else:
        positions = public_batch(shape) * S.token_len(cfg, shape)
        if "sparse" in check_variant(variant):
            client = sparse_share_bytes(N_CLIENTS, positions, SPARSE_K)
        else:
            client = dml.comm_bytes(cfg, N_CLIENTS, positions)["dml_round"]
    total = client / N_CLIENTS if mesh_kind == "clients" else 0
    return {"client_axis": float(client), "total": float(total)}


def model_flops_estimate(cfg, shape, method: str = "standard") -> float:
    """Useful model FLOPs for one step of (cfg, shape, method).

    The classic parameter-FLOP model: a forward pass costs 2·N·D (N =
    active params, D = tokens) and training costs 6·N·D — forward AND
    backward, since every kernel on the hot path (attention, SSD,
    mutual-KL) now carries a custom VJP and trains through the same impl
    it runs forward.  Decode shapes process one token per step; the DML /
    mutual methods add the public-batch mutual phase (trained, so 6·N·D)
    for k = 2 clients; fedavg_sync moves no tokens at all.
    """
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    if method == "fedavg_sync":
        tokens = 0
    active = cfg.active_param_count()
    flops_per_tok = 6 * active if shape.kind == "train" else 2 * active
    model_flops = float(flops_per_tok) * tokens
    if method in ("dml", "mutual"):
        k = 2
        pub = max(1, shape.global_batch // (4 * k)) * shape.seq_len
        extra = 6.0 * active * pub * k        # mutual phase is trained
        model_flops = (model_flops if method == "dml" else 0.0) + extra
    return model_flops


def run_case(arch: str, shape_name: str, mesh_kind: str,
             method: str = "standard", verbose: bool = True,
             variant: str = "baseline") -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    sharded = mesh_kind in PRODUCTION
    n_chips = (PRODUCTION[mesh_kind][0] if sharded
               else N_CLIENTS if mesh_kind == "clients" else 1)
    t0 = time.time()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "method": method, "chips": n_chips, "status": "ok",
        "variant": variant,
    }
    try:
        fn, args = build_case(cfg, shape, mesh_kind, method, variant)
        if sharded:
            c = count_sharded(fn, args, case_axes(cfg, shape, method),
                              production_mesh(mesh_kind),
                              mesh_rules(method, variant))
            del fn, args
            share = 1                  # one card counted
        else:
            with count() as c:
                out = fn(*args)    # alive at the count's end: the outputs
            del fn, args, out
            # one client a card on the clients mesh: a card's share
            share = n_chips
        for key in ("argument_bytes", "output_bytes", "temp_bytes",
                    "peak_bytes"):
            rec[key] = getattr(c, key) / share
        rec["flops_per_device"] = c.flops / share
        rec["bytes_per_device"] = c.bytes / share
        rec["collectives"] = (c.collectives if sharded else collectives(
            cfg, shape, mesh_kind, method, variant))
        rl = roofline_terms(rec["flops_per_device"], rec["bytes_per_device"],
                            rec["collectives"]["total"])
        rec.update({k: rl[k] for k in ("t_compute", "t_memory",
                                       "t_collective", "dominant")})
        model_flops = model_flops_estimate(cfg, shape, method)
        rec["model_flops"] = model_flops
        total = rec["flops_per_device"] * n_chips
        rec["useful_flop_ratio"] = model_flops / total if total else 0.0
        rec["count_s"] = time.time() - t0
    except Exception as e:  # noqa: BLE001 — a failed case is a bug to record
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        rec["count_s"] = time.time() - t0
    if verbose:
        if rec["status"] == "ok":
            print(f"[ok] {arch} {shape_name} {mesh_kind} {method} "
                  f"({rec['count_s']:.0f}s) dominant={rec['dominant']} "
                  f"tc={rec['t_compute']:.4f} tm={rec['t_memory']:.4f} "
                  f"tx={rec['t_collective']:.4f} "
                  f"useful={rec['useful_flop_ratio']:.2f} "
                  f"peakGB={rec['peak_bytes']/2**30:.1f}", flush=True)
        else:
            print(f"[FAIL] {arch} {shape_name} {mesh_kind} {method} "
                  f"({rec['count_s']:.0f}s) err={rec['error'][:160]}",
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESH_KINDS), default="single")
    ap.add_argument("--method", default="standard", choices=list(METHODS))
    ap.add_argument("--all", action="store_true",
                    help="baseline sweep: every arch x shape on --mesh")
    ap.add_argument("--variant", default="baseline",
                    help="baseline | chunked_ce | noremat | slotremat | "
                         "sparse, joined by '+'")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)
    try:
        check_variant(args.variant)
        check_mesh(args.mesh, args.method)
    except ValueError as e:
        ap.error(str(e))

    records = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                records.append(run_case(arch, shape_name, args.mesh,
                                        args.method, variant=args.variant))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        records.append(run_case(args.arch, args.shape, args.mesh,
                                args.method, variant=args.variant))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    bad = [r for r in records if r["status"] != "ok"]
    print(f"\n{len(records) - len(bad)}/{len(records)} cases counted")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
