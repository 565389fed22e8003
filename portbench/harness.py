"""One run of one cell: set-up, the measured window, the traced window and
the check that decides ``correct``.

The program is ``repro_torch``: ``Federation(LMClients(...), DML())``,
driven one round after another (closed loop) by ``fed.run(until=r + 1)``.
Set-up builds that one session, hands it the weights the benchmark made
from the seed, and drives it through the rounds the check reads (their
losses, the optimizer's state after the first, the parameters after the
third) and one more, so that every shape and allocation is warm before
the window.  After the window the program is freed and the plain
reference (``reference.py``) replays the checked rounds.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch

from portbench import check
from portbench import weights as W
from portbench.yard import trace as T

HERE = Path(__file__).resolve().parent
ROUND_SPAN = T.SPAN_PREFIX + "round"
# a traffic file's keys, and the values of those the program has no option
# for: it runs DML, every client every round, one round after another
TRAFFIC_KEYS = {"strategy", "kl_weight", "participation", "loop", "clients",
                "batch", "public_batch", "seq", "cards", "lr", "warmup",
                "rounds", "clip_norm", "why"}
DRIVEN = {"strategy": "dml", "participation": "full", "loop": "closed"}
PROFILED_ROUNDS = 4
# host ranges the traced run opens around calls into the program's layers:
# (module, class or None, attribute, span); a name the program no longer
# has is skipped
SPANS = (
    ("repro_torch.core.populations.lm", "LMClients", "_private_batch",
     "private_batch"),
    ("repro_torch.core.populations.lm", "LMClients", "_public_batch",
     "public_batch"),
    ("repro_torch.core.distributed", None, "value_and_grad",
     "loss_and_grad"),
    ("repro_torch.core.distributed", "ShardedDMLStep", "_run",
     "sharded_loss_and_grad"),
    ("repro_torch.core.distributed", None, "adamw_update", "adamw"),
    ("repro_torch.core.stacking", None, "gather_clients", "gather"),
)


# ---------------------------------------------------------------------------
# the cell's files

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell ``workloads/<name>.json`` with its configuration and
    traffic files read in."""
    cell = _json(HERE / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config"] = _json(HERE / "configs" / f"{cell['config']}.json")
    cell["traffic"] = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell


def metric_modules() -> Dict[str, object]:
    """Every per-layer metric's reader, ``metrics/<name>.py``, by name."""
    return {p.stem: importlib.import_module(f"portbench.metrics.{p.stem}")
            for p in sorted((HERE / "metrics").glob("*.py"))
            if p.stem != "__init__"}


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file's model."""
    from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
    kw = dict(cfg)
    kw["period"] = tuple(LayerSpec(**s) for s in cfg["period"])
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    return ModelConfig(**kw)


def tokens_per_round(tr: dict) -> int:
    return tr["clients"] * (tr["batch"] + tr["public_batch"]) * tr["seq"]


# ---------------------------------------------------------------------------
# the program

def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _paths(tree) -> Dict[tuple, torch.Tensor]:
    return dict(W.leaves(tree))


class Program:
    """The session under test and its views of the clients' state."""

    def __init__(self, cell: dict, seed: int, devices, impl: str):
        from repro_torch.api import DML, Federation, LMClients
        from repro_torch.launch.mesh import make_client_mesh
        tr, cfg = cell["traffic"], cell["config"]["model"]
        self.cell, self.seed, self.devices = cell, seed, devices
        unknown = set(tr) - TRAFFIC_KEYS
        if unknown or any(tr[k] != v for k, v in DRIVEN.items()):
            raise ValueError(f"the program cannot drive this traffic: keys "
                             f"{sorted(unknown)}, or not {DRIVEN}")
        if tr["public_batch"] != max(1, tr["batch"] // 2):
            raise ValueError("LMClients draws a public batch of "
                             "max(1, batch // 2) sequences")
        mesh = None
        if tr["cards"] > 1:
            mesh = make_client_mesh(tr["cards"], device=devices[0].type)
        t0 = time.perf_counter()
        self.pop = LMClients(model_config(cfg), n_clients=tr["clients"],
                             rounds=tr["rounds"], batch=tr["batch"],
                             seq=tr["seq"], lr=tr["lr"], seed=seed,
                             mesh=mesh, device=devices[0], kernel_impl=impl)
        self.population_s = time.perf_counter() - t0     # its own draw too
        o = self.pop.opt_cfg
        stated = (tr["warmup"], tr["rounds"], tr["lr"], 0.9, 0.95, 1e-8,
                  0.1, tr["clip_norm"], "cosine")
        if (o.warmup, o.total_steps, o.lr, o.b1, o.b2, o.eps,
                o.weight_decay, o.clip_norm, o.schedule) != stated:
            raise ValueError(f"the program's optimizer {o} departs from the "
                             "traffic's stated one")
        own = {p: (t.shape, t.dtype) for p, t in
               _paths(self.pop.client_params).items()}
        self.pop.client_params = None            # the program's own draw
        mine = W.make_weights(cfg, tr["clients"], seed, devices[0])
        if own != {p: (t.shape, t.dtype) for p, t in _paths(mine).items()}:
            raise ValueError("the benchmark's weights do not fit the "
                             "program's parameter layout")
        self.pop.client_params = mine
        del mine
        self.fed = Federation(self.pop, DML(kl_weight=tr["kl_weight"]))

    def round(self) -> None:
        self.fed.run(until=self.fed.round + 1)
        _sync(self.devices)

    def _client_leaves(self, which: str):
        """(client, path, tensor of that client's leaf) over the state in
        whichever layout it is: ``which`` is "params" or "mu"."""
        from repro_torch.core import stacking
        pop, K = self.pop, self.cell["traffic"]["clients"]
        if pop._entries is None:
            tree = pop._client_params if which == "params" \
                else pop._client_opts["mu"]
            for path, t in W.leaves(tree):
                for c in range(K):
                    yield c, path, t[c]
            return
        params, opts = pop._entries
        rows = stacking.entry_rows(K, len(params))
        for d, (p, o) in enumerate(zip(params, opts)):
            tree = p if which == "params" else o["mu"]
            ids = stacking.local_client_ids(K, len(params), d).tolist()
            for path, t in W.leaves(tree):
                for slot, (gid, c) in enumerate(zip(ids, rows[d])):
                    if gid < K:                 # not a wrapped dummy
                        yield int(c), path, t[slot]

    def grad_norms(self) -> List[Dict[tuple, float]]:
        """After one step: each client's first gradient as AdamW got it,
        by leaf: the first moment over 1 - b1."""
        out = [dict() for _ in range(self.cell["traffic"]["clients"])]
        for c, path, t in self._client_leaves("mu"):
            out[c][path] = float(t.double().norm()) / (1 - 0.9)
        return out

    def change_norms(self, start: dict) -> List[Dict[tuple, float]]:
        """Each client's parameter change from ``start`` (the stacked
        tree the session began from), by leaf."""
        out = [dict() for _ in range(self.cell["traffic"]["clients"])]
        p0 = _paths(start)
        for c, path, t in self._client_leaves("params"):
            out[c][path] = float((t.double()
                                  - p0[path][c].to(t.device).double()).norm())
        return out

    def losses(self, r: int) -> Dict[str, List[float]]:
        log = self.fed.history.rounds[r]
        return {"private_ce": list(log.client_loss),
                "public_ce": list(log.public_ce), "kl": list(log.kl_loss)}


def kernel_launches() -> Dict[str, int]:
    """The port's per-entry-call launch counters, by kernel family."""
    from repro_torch.kernels import flash_attention, kl_mutual, ssd_scan
    return {"eq2": kl_mutual.launches + kl_mutual.bwd_launches,
            "flash": flash_attention.launches + flash_attention.bwd_launches,
            "ssd": ssd_scan.launches + ssd_scan.bwd_launches}


# the port's libraries (``csrc/<name>.cu``) behind each kernel family
LIBRARIES = {"eq2": ("kl_mutual_pair",),
             "flash": ("flash_attention_fwd", "flash_attention_bwd"),
             "ssd": ("ssd_scan_fwd", "ssd_scan_bwd")}


def load_kernels(cfg: dict) -> float:
    """Builds (a checkout's first run) or loads the libraries of the
    cell's kernel families before the session is built; returns the
    seconds it took.  A library the port no longer has is left to the
    program's own first use."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    for fam in expected_kernels(cfg):
        for name in LIBRARIES[fam]:
            if (_build.CSRC / f"{name}.cu").exists():
                _build.load(name)
    return time.perf_counter() - t0


def expected_kernels(cfg: dict) -> List[str]:
    mixers = {s["mixer"] for s in cfg["period"]}
    return ["eq2"] + (["flash"] if "attn" in mixers else []) \
        + (["ssd"] if "mamba" in mixers else [])


def set_up(cell: dict, seed: int, devices, impl: str, phases=None):
    """The session, driven through the checked rounds and one more.
    Returns (program, its readings); ``phases`` gets each stage's
    seconds."""
    phases = {} if phases is None else phases
    t0 = time.perf_counter()
    prog = Program(cell, seed, devices, impl)
    phases["population"] = prog.population_s
    phases["weights"] = time.perf_counter() - t0 - prog.population_s
    before = kernel_launches()
    readings = check.Readings()
    prog.round()
    if impl == "cuda":
        ran = kernel_launches()
        idle = [k for k in expected_kernels(cell["config"]["model"])
                if ran[k] == before[k]]
        if idle:
            raise RuntimeError(f"the round ran none of the port's {idle} "
                               "kernels")
    readings.grad_norms = prog.grad_norms()
    n = check.checked_rounds(cell)
    for _ in range(n - 1):
        prog.round()
    start = W.make_weights(cell["config"]["model"],
                           cell["traffic"]["clients"], seed, devices[0])
    readings.change_norms = prog.change_norms(start)
    del start
    readings.losses = [prog.losses(r) for r in range(n)]
    t1 = time.perf_counter()
    phases["checked_rounds"] = t1 - t0 - prog.population_s - phases["weights"]
    prog.round()                    # warm again after the reads' memory
    phases["warm_round"] = time.perf_counter() - t1
    return prog, readings


# ---------------------------------------------------------------------------
# the windows

@contextlib.contextmanager
def host_spans():
    """Opens a ``record_function`` range around each call of ``SPANS``."""
    from torch.profiler import record_function
    undo = []
    for mod_name, cls, attr, span in SPANS:
        owner = importlib.import_module(mod_name)
        if cls is not None:
            owner = getattr(owner, cls, None)
        fn = getattr(owner, attr, None) if owner is not None else None
        if fn is None:
            continue

        def wrapped(*a, __fn=fn, __span=T.SPAN_PREFIX + span, **kw):
            with record_function(__span):
                return __fn(*a, **kw)
        functools.update_wrapper(wrapped, fn)
        setattr(owner, attr, wrapped)
        undo.append((owner, attr, fn))
    try:
        yield
    finally:
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)


def timed_window(prog: Program, seconds: float, ends=None):
    """Rounds back to back for ``seconds``: (rounds that ended inside,
    seconds from the start to the last of them); ``ends`` gets each
    round's end, in seconds from the start."""
    t0 = time.perf_counter()
    n, last = 0, t0
    while True:
        prog.round()
        t = time.perf_counter()
        if t - t0 > seconds:
            break
        n, last = n + 1, t
        if ends is not None:
            ends.append(t - t0)
    if n == 0:
        raise RuntimeError(f"no round ended within {seconds} s")
    return n, last - t0


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: dict
    trace: T.Trace
    unprofiled_rounds: int
    unprofiled_s: float


def traced_window(prog: Program, seconds: float, device_idx):
    """An unprofiled stretch of half the window (MFU), then
    ``PROFILED_ROUNDS`` rounds under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    n, t = timed_window(prog, seconds / 2)
    with host_spans(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_ROUNDS):
            with record_function(ROUND_SPAN):
                prog.round()
    return Context(prog.cell, T.from_profiler(prof, device_idx, ROUND_SPAN),
                   n, t)


def breakdown(ctx: Context) -> dict:
    """The 10 device operations that took most time a round, and the
    device's idle time a round by the host span open at each gap's
    middle, summed over the cards."""
    tr = ctx.trace
    ops = sorted(T.by_name(tr).items(), key=lambda kv: -kv[1])[:10]
    idle: Dict[str, float] = {}
    for d in tr.devices:
        for a, b in T.idle_gaps(tr, d):
            label = T.span_at(tr, (a + b) / 2).removeprefix(T.SPAN_PREFIX)
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    n = tr.n_rounds
    return {"device_ops": [[name[:120], s / n] for name, s in ops],
            "idle_gaps": [[name, s / n] for name, s in gaps]}


# ---------------------------------------------------------------------------
# one run

def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             devices, t_start: float, log=sys.stderr) -> dict:
    """Everything of one run but the chip's look and the import check;
    returns the result line's object."""
    impl = "cuda" if devices[0].type == "cuda" else "ref"
    tr = cell["traffic"]
    cuda = devices[0].type == "cuda"
    phases = {"imports": time.perf_counter() - t_start}
    phases["build"] = load_kernels(cell["config"]["model"]) if cuda else 0.0
    prog, readings = set_up(cell, seed, devices, impl, phases)
    if cuda:
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    out: dict = {}
    idx = sorted({d.index or 0 for d in devices})
    if trace:
        ctx = traced_window(prog, seconds, idx)
        metrics = {}
        for name, mod in metric_modules().items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
        attempted = ctx.unprofiled_rounds + PROFILED_ROUNDS
        busy = statistics.mean(T.busy_us(ctx.trace, d) for d in idx) / 1e6
        extra = {"busy_s": busy,
                 "window_s": (ctx.trace.end - ctx.trace.start) / 1e6}
        out["breakdown"] = breakdown(ctx)
    else:
        ends: List[float] = []
        n, secs = timed_window(prog, seconds, ends)
        rounds_ms = [1e3 * (b - a) for a, b in zip([0.0] + ends, ends)]
        print("portbench: rounds (ms) first {:.1f}, min {:.1f}, median "
              "{:.1f}, max {:.1f}".format(rounds_ms[0], min(rounds_ms),
                                          statistics.median(rounds_ms),
                                          max(rounds_ms)), file=log)
        attempted = n
        metrics = {"setup_s": {"value": setup_s, "unit": "s"},
                   "train_tok_s": {"value": n * tokens_per_round(tr) / secs,
                                   "unit": "tokens/s"}}
        extra = {}
    peak = max((torch.cuda.max_memory_allocated(d) for d in set(devices)),
               default=0) if cuda else 0
    if not trace:
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda
              else "cpu", "count": len(set(devices)),
              "memory_peak_bytes": peak, "build_s": phases["build"],
              **extra}
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, ok = verify(cell, seed, devices, readings)
    print(f"portbench: set-up {setup_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()) + "), reference "
        f"{time.perf_counter() - t_ref:.1f} s", file=log)
    limits = cell["limits"]
    free = [f"{k} {v!r}" for k, v in nums.items() if k not in limits]
    if free:
        print("portbench: not compared: " + ", ".join(free), file=log)
    for k, v in limits.items():
        print(f"check {k} {nums[k]!r} limit {v!r}", file=log)
    return {"correct": ok, "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": device, **out,
            "checks": {k: {"value": nums[k], "limit": v}
                       for k, v in limits.items()}}


def ref_devices(devices) -> list:
    """The cards the reference spreads its clients over: the run's."""
    return sorted(set(devices), key=lambda d: d.index or 0)


def verify(cell: dict, seed: int, devices, readings: check.Readings):
    """(numbers, correct) of the program's readings against the
    reference's, replayed from the same seed."""
    ref = check.reference_readings(cell, seed, ref_devices(devices))
    nums = check.numbers(readings, ref)
    return nums, check.judge(nums, cell["limits"])


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)
