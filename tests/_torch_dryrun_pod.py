"""Subprocess body of ``tests/test_torch_dryrun_pod.py``: the port's
dry-run (``repro_torch.launch.dryrun``) on PyTorch's fake process group of
8 ranks as a (pod 2, data 2, model 2) DeviceMesh, at reduced configs: the
machinery of the ``multi`` mesh without its 512 ranks.  Prints one JSON
object a case.  Run through the test only:

    python tests/_torch_dryrun_pod.py matmul moe qwen3-4b:dml:train ...
"""
import json
import sys
import warnings

import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR


def small_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import flat_dims
    DR.fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for dims in flat_dims(mesh):
        mesh[dims]._flatten("_".join(dims))
    return mesh


def record(c) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
            "collectives": c.collectives}


def moe_case(mesh) -> dict:
    """Reduced qwen2-moe-a2.7b's MoE FFN forward alone (one client, 8
    sequences of 32, fp32) with its logical axes: the batch over (pod,
    data), the experts over model, the router and experts FSDP over data."""
    from repro_torch import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models.layers import make_generator
    cfg = get_reduced("qwen2-moe-a2.7b")
    meta = torch.device("meta")
    params = moe.init_moe(make_generator(0, meta), cfg, (1,))
    axes = shd.axes_map(lambda ax: ("client",) + ax,
                        moe.moe_logical_axes(cfg))
    x = torch.empty((1, 8, 32, cfg.d_model), dtype=torch.float32,
                    device=meta)
    c = DR.count_sharded(lambda p, h: moe.apply_moe(p, cfg, h), (params, x),
                         (axes, ("client", "batch", "seq", "embed_act")),
                         mesh)
    m = cfg.moe
    return {"case": "moe", "d": cfg.d_model, "experts": m.n_experts,
            "top_k": m.top_k, "d_expert": m.d_expert,
            "shared": m.n_shared_experts, "capacity_factor":
            m.capacity_factor, **record(c)}


def case(spec: str) -> dict:
    """"matmul", "moe", or "<arch>:<method>:<kind>[:<variant>]" at its
    reduced config cut to one period, 8 sequences of 32."""
    mesh = small_mesh()
    if spec == "moe":
        return moe_case(mesh)
    if spec == "matmul":
        x = torch.empty((8, 64), dtype=torch.bfloat16, device="meta")
        w = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
        c = DR.count_sharded(torch.matmul, (x, w),
                             (("batch", None), (None, "ff")), mesh)
        return {"case": spec, **record(c)}
    arch, method, kind, *variant = spec.split(":")
    variant = variant[0] if variant else "baseline"
    cfg = get_reduced(arch)
    cfg = cfg.replace(n_layers=len(cfg.period))
    shape = ShapeConfig("small", seq_len=32, global_batch=8, kind=kind)
    fn, args = DR.build_case(cfg, shape, "multi", method, variant)
    c = DR.count_sharded(fn, args, DR.case_axes(cfg, shape, method), mesh,
                         DR.mesh_rules(method, variant))
    return {"case": spec, "public": DR.public_batch(shape),
            "seq": shape.seq_len, "vocab": cfg.vocab_size, **record(c)}


def main(argv):
    warnings.filterwarnings("ignore")
    for spec in argv:
        print(json.dumps(case(spec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
