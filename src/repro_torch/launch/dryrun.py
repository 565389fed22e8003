"""Dry-run of the port: build every (arch x shape x mesh x method) on
PyTorch's meta device, allocating nothing, and count what eager PyTorch
dispatches, for the roofline report (the port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \
      --out build/dryrun/single.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \
      --shape train_4k --mesh clients --method dml
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
  - Collectives are computed from shapes, not parsed: the public logits
    the clients exchange (``distributed.comm_bytes``; SparseDML's top-k
    sets by ``mutual.sparse_share_bytes``) for ``dml`` and ``mutual``, the
    parameter average for ``fedavg_sync``, none for ``standard``.

Meshes: ``single`` is one card (every client of a client method on it, so
nothing crosses a link: ``collectives["total"]`` is 0 and
``"client_axis"`` says what would cross one).  ``clients`` puts one client
on each card, as the client mesh (``sharding.ClientMesh``) runs
``make_sharded_dml_step``: the clients' work is alike, so a card's counts
are the program's over the client count, and ``t_collective`` is a card's
share of the exchanged bytes at the link rate.  The JAX ``multi`` mesh (two
256-chip pods) and the data x model production mesh are not ported.

Not ported, and why: ``collective_stats``, ``_parse_groups``,
``_pod_class``, ``_type_bytes`` and ``cost_dict`` parse HLO;
``depth_corrected_costs`` corrects XLA's once-counted scan body, and eager
dispatch counts every layer; ``_shardings`` maps logical axes, which the
port does not have.  Of the variants, ``flash`` (the ``xla_flash`` impl) is
out by design, and ``attn_dp``, ``no_fsdp`` and ``seqpar`` are axis rules
of the data x model mesh; all four are refused.
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

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
VARIANTS = ("baseline", "chunked_ce", "noremat", "slotremat", "sparse")
REFUSED = {
    "flash": "the xla_flash impl is not ported (by design): the port's "
             "flash attention is the hand-written kernel, impl 'cuda'",
    **{v: f"{v} is an axis rule of the data x model production mesh, "
          "which is not ported yet (the data x model slice)"
       for v in ("attn_dp", "no_fsdp", "seqpar")},
}


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

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts op bytes and follows storages: one made inside is live until
    its storage dies (a ``weakref.finalize`` on the storage, whose Python
    object lives as long as the storage does)."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts
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
        for t in outs:
            self._check(func, t)
        if not func.is_view:
            self.counts.bytes += sum(_nbytes(t) for t in ins + outs)
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

    def finish(self) -> None:
        c = self.counts
        c.argument_bytes = self.arg_bytes
        c.output_bytes = self.now
        c.temp_bytes = self.peak - self.now


@contextlib.contextmanager
def count():
    """Count the ops run inside: ``with count() as c: step(*args)``, then
    ``c.flops``, ``c.bytes`` and the byte fields.  FLOPs are those of a
    ``FlopCounterMode`` over the same ops.  Raises if an op sees a tensor
    that is not on the meta device (0-d and empty CPU tensors aside): a
    dry-run never computes by accident."""
    counts = Counts()
    counter = _Counter(counts)
    flops = FlopCounterMode(display=False)
    with counter, flops:
        yield counts
    counts.flops = flops.get_total_flops()
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
             kl_weight: float = 1.0, device=S.META):
    """(fn, args) of one client-stacked DML step (``fused``: private CE +
    Eq. 1, ``make_dml_train_step``; else Eq. 1 alone, ``make_mutual_step``)
    of ``n_clients`` clients, ``batch`` private and ``public`` shared
    sequences of ``seq`` tokens, at impl "ref".  On the meta device
    nothing is drawn; elsewhere the params are drawn from seed 0 and the
    tokens are zeros, so that the same program runs on a card."""
    opt_cfg = opt_cfg or AdamWConfig()
    if fused:
        step = dml.make_dml_train_step(cfg, opt_cfg, kl_weight=kl_weight,
                                       sparse_k=sparse_k, impl="ref")
    else:
        step = dml.make_mutual_step(cfg, opt_cfg, kl_weight=kl_weight,
                                    sparse_k=sparse_k, impl="ref")
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


def _case_dml(cfg, shape, fused=True, sparse_k=0):
    """The paper's technique: N_CLIENTS clients share the global batch."""
    if shape.global_batch % N_CLIENTS:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {N_CLIENTS} clients")
    return dml_case(cfg, N_CLIENTS, shape.global_batch // N_CLIENTS,
                    public_batch(shape), S.token_len(cfg, shape),
                    fused=fused, sparse_k=sparse_k)


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
                         f"{MESH_KINDS} (JAX's multi-pod and data x model "
                         "meshes are not ported)")
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
        return _case_dml(cfg, shape, fused=method == "dml", sparse_k=sparse_k)
    return _case_fedavg_sync(cfg)


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
    n_chips = N_CLIENTS if mesh_kind == "clients" else 1
    t0 = time.time()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "method": method, "chips": n_chips, "status": "ok",
        "variant": variant,
    }
    try:
        fn, args = build_case(cfg, shape, mesh_kind, method, variant)
        with count() as c:
            out = fn(*args)        # alive at the count's end: the outputs
        del fn, args, out
        # one client a card on the clients mesh: a card's share
        for key in ("argument_bytes", "output_bytes", "temp_bytes",
                    "peak_bytes"):
            rec[key] = getattr(c, key) / n_chips
        rec["flops_per_device"] = c.flops / n_chips
        rec["bytes_per_device"] = c.bytes / n_chips
        rec["collectives"] = collectives(cfg, shape, mesh_kind, method,
                                         variant)
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
