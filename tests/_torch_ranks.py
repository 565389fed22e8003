"""Run the port on n CPU ranks over gloo, for the data x model mesh tests.

``Ranks(name, n, tmp_path, **inputs)`` starts n Python processes, each
rank ``r`` of a gloo process group joined through a ``FileStore`` under
``tmp_path`` (never a fixed TCP port: test workers run at once), running
the rank program ``name`` of this module on ``inputs``; ``.result()``
waits and returns rank 0's result (a dict of numpy arrays), so a test can
compute meanwhile.  A rank that fails fails the call with every rank's
output.  The rank programs import ``torch`` and the port only, never JAX:
the tests compute their references in their own process.

    python tests/_torch_ranks.py <program> <rank> <n> <dir>
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


class Ranks:
    """n rank processes of the rank program ``name`` on ``inputs``,
    started at once; ``result()`` waits for them and returns rank 0's
    result, or raises with every rank's output if one failed."""

    def __init__(self, name: str, n: int, tmp_path, timeout: float = 240.0,
                 **inputs):
        self.tmp, self.timeout = Path(tmp_path), timeout
        with open(self.tmp / "ranks_in.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(SRC), os.environ.get("PYTHONPATH", "")]),
            "PYTHONWARNINGS": "ignore", "OMP_NUM_THREADS": "1"}
        self.logs = [open(self.tmp / f"rank{r}.log", "w+") for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, name, str(r), str(n), str(self.tmp)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]

    def result(self) -> dict:
        try:
            codes = [p.wait(timeout=self.timeout) for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        try:
            if any(codes):
                out = []
                for r, log in enumerate(self.logs):
                    log.seek(0)
                    out.append(f"--- rank {r} (exit {codes[r]}):\n"
                               + log.read()[-3000:])
                raise RuntimeError("a rank failed:\n" + "\n".join(out))
            with open(self.tmp / "ranks_out.pkl", "rb") as f:
                return pickle.load(f)
        finally:
            for log in self.logs:
                log.close()


# ---------------------------------------------------------------------------
# rank programs: (rank, n, **inputs) -> rank 0's result

def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _gathered(tree) -> dict:
    """A tree of DTensors gathered whole, as a flat dict of numpy arrays."""
    from repro_torch.checkpoint import flatten
    return {k: _np(v) for k, v in flatten(tree).items()}


def mesh_steps(rank, n, params, sparams, mparams, train_tokens, tokens,
               public, opt, sparse_k, topk_cases):
    """The reduced-size slice L programs at impl "ref" on a (data 2, model
    2) mesh: one ``make_train_step`` step of ``params``, one fused DML
    round and one SparseDML round of the client-stacked ``sparams``; the
    train step again on a (data 1, model 4) mesh (each rank's query heads
    take their key/value group's head); a reduced mamba2-780m train step
    of ``mparams`` on the (2, 2) mesh; and the vocab-sharded top-k of
    ``topk_cases`` on both meshes.  Params cross as flat numpy dicts."""
    import torch

    from repro_torch import interop
    from repro_torch import sharding as shd
    from repro_torch.configs import get_reduced
    from repro_torch.core import distributed as D
    from repro_torch.core.mutual import _distributed_topk
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init

    torch.set_num_threads(1)
    cfg = get_reduced("qwen3-4b")
    opt_cfg = AdamWConfig(**opt)
    meshes = {"2x2": make_cpu_mesh((2, 2)), "1x4": make_cpu_mesh((1, 4))}
    out = {}

    def state(flat, axes, mesh):
        p = shd.distribute_tree(interop.params_from_numpy(flat, device="cpu"),
                                axes, mesh)
        return p, adamw_init(p)

    def put(a, axes, mesh):
        return shd.distribute(torch.as_tensor(a), axes, mesh)

    for tag in ("2x2", "1x4"):
        mesh = meshes[tag]
        p, o = state(params, tfm.logical_axes(cfg), mesh)
        step = steps.make_train_step(cfg, opt_cfg, impl="ref")
        with shd.use_mesh(mesh):
            p, o, m = step(p, o, put(train_tokens, ("batch", "seq"), mesh))
        out[f"train_{tag}"] = {"metrics": {k: _np(v) for k, v in m.items()
                                           if k != "lr"},
                               "params": _gathered(p),
                               "mu": _gathered(o["mu"])}
    mesh = meshes["2x2"]
    for name, sk in (("dml", 0), ("sparse", sparse_k)):
        p, o = state(sparams, D.stacked_logical_axes(cfg), mesh)
        step = D.make_dml_train_step(cfg, opt_cfg, sparse_k=sk, impl="ref")
        with shd.use_mesh(mesh):
            p, o, m = step(p, o, put(tokens, ("client", "batch", "seq"), mesh),
                           put(public, ("batch", "seq"), mesh))
        out[name] = {"metrics": {k: _np(v) for k, v in m.items()
                                 if k != "lr"},
                     "params": _gathered(p), "mu": _gathered(o["mu"])}
    # mamba2's SSD scan on each rank's (batch, heads) shard
    mcfg = get_reduced("mamba2-780m")
    p, o = state(mparams, tfm.logical_axes(mcfg), mesh)
    step = steps.make_train_step(mcfg, opt_cfg, impl="ref")
    with shd.use_mesh(mesh):
        p, o, m = step(p, o, put(train_tokens, ("batch", "seq"), mesh))
    out["mamba2"] = {"metrics": {k: _np(v) for k, v in m.items()
                                 if k != "lr"},
                     "params": _gathered(p), "mu": _gathered(o["mu"])}
    for tag, mesh in meshes.items():
        got = []
        for logp, k in topk_cases:
            x = put(logp, ("client", None, "vocab"), mesh)
            with shd.use_mesh(mesh):
                vals, idx = _distributed_topk(x, k)
            got.append((_np(vals), _np(idx).astype("int64"),
                        str(x.placements)))
        out[f"topk_{tag}"] = got
    return out


def moe_steps(rank, n, params, params6, sparams, qparams, train_tokens,
              tokens, public, opt):
    """The MoE FFN and the client-on-pod round as DTensor programs at impl
    "ref": reduced qwen2-moe-a2.7b (4 experts, 1 shared) on a (data 2,
    model 2) mesh, where the experts are split, one ``make_train_step``
    step of ``params`` and one fused DML round of the client-stacked
    ``sparams``; the train step of ``params6`` (6 experts) on a (data 1,
    model 4) mesh, where ``ff`` is split; and one fused DML round of
    reduced qwen3-4b's ``qparams`` on a (pod 2, data 1, model 2) mesh with
    the clients on ``pod`` (``spmd_client_axis="pod"``, the dry-run's DML
    rules), whose Eq.-2 term takes ``ops._pair_local``'s rectangular
    branch.  Each MoE case logs its routes (``moe.route_log``) sharded on
    every rank and unsharded on rank 0, from the same params."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import flatten
    from repro_torch.configs import get_reduced
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init

    torch.set_num_threads(1)
    cfg = get_reduced("qwen2-moe-a2.7b")
    cfg6 = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=6))
    opt_cfg = AdamWConfig(**opt)
    meshes = {"2x2": make_cpu_mesh((2, 2)), "1x4": make_cpu_mesh((1, 4)),
              "pod": make_cpu_mesh((2, 1, 2), ("pod", "data", "model"))}
    out = {}

    def put(a, axes, mesh):
        t = torch.as_tensor(a)
        return t if mesh is None else shd.distribute(t, axes, mesh)

    def run(name, c, flat, mesh, stacked, rules=None, client_axis=None):
        """The step on ``mesh`` (None: unsharded) from ``flat``: metrics,
        params and first moments gathered, and the routes."""
        with shd.axis_rules(rules or {}):
            p = interop.params_from_numpy(flat, device="cpu")
            axes = (D.stacked_logical_axes(c) if stacked
                    else tfm.logical_axes(c))
            if mesh is not None:
                p = shd.distribute_tree(p, axes, mesh)
            o = adamw_init(p)
            moe.route_log = [] if c.moe else None
            try:
                with shd.use_mesh(mesh):
                    if stacked:
                        step = D.make_dml_train_step(
                            c, opt_cfg, impl="ref",
                            spmd_client_axis=client_axis)
                        p, o, m = step(
                            p, o, put(tokens, ("client", "batch", "seq"),
                                      mesh),
                            put(public, ("batch", "seq"), mesh))
                    else:
                        step = steps.make_train_step(c, opt_cfg, impl="ref")
                        p, o, m = step(p, o, put(train_tokens,
                                                 ("batch", "seq"), mesh))
                routes = [(i.numpy(), k.numpy())
                          for i, k in moe.route_log or []]
            finally:
                moe.route_log = None
        rec = {"metrics": {k: _np(v) for k, v in m.items() if k != "lr"},
               "params": _gathered(p), "mu": _gathered(o["mu"]),
               "routes": routes}
        if mesh is not None:
            rec["placements"] = {k: str(v.placements)
                                 for k, v in flatten(p).items()}
        out[name] = rec

    for name, c, flat, tag, stacked in (
            ("moe_train", cfg, params, "2x2", False),
            ("moe_dml", cfg, sparams, "2x2", True),
            ("moe_train_ff", cfg6, params6, "1x4", False)):
        run(name, c, flat, meshes[tag], stacked)
        if rank == 0:
            run(name + "_unsharded", c, flat, None, stacked)
    # the Eq.-2 calls' local (live, fixed) shapes on the pod mesh
    pair, shapes = ref.mutual_kl_pair, []

    def logged(live, fixed, *a, **kw):
        shapes.append((tuple(live.shape), tuple(fixed.shape)))
        return pair(live, fixed, *a, **kw)
    ref.mutual_kl_pair = logged
    try:
        run("pod_dml", get_reduced("qwen3-4b"), qparams, meshes["pod"],
            True, rules=dryrun.mesh_rules("dml"), client_axis="pod")
    finally:
        ref.mutual_kl_pair = pair
    out["pod_dml"]["pair_shapes"] = shapes
    return out


def _main(name: str, rank: int, n: int, tmp: str) -> None:
    import torch.distributed as dist
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"),
                                                         n),
                            rank=rank, world_size=n)
    try:
        with open(tmp / "ranks_in.pkl", "rb") as f:
            inputs = pickle.load(f)
        out = globals()[name](rank, n, **inputs)
        if rank == 0:
            with open(tmp / "ranks_out.pkl", "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
