"""Subprocess body of ``tests/test_torch_dryrun_pod.py``: the port's
dry-run (``repro_torch.launch.dryrun``) on PyTorch's fake process group of
8 ranks as a (pod 2, data 2, model 2) DeviceMesh, at reduced configs: the
machinery of the ``multi`` mesh without its 512 ranks.  Prints one JSON
object a case.  Run through the test only:

    python tests/_torch_dryrun_pod.py matmul qwen3-4b:dml:train ...
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


def case(spec: str) -> dict:
    """"matmul", or "<arch>:<method>:<kind>[:<variant>]" at its reduced
    config cut to one period, 8 sequences of 32."""
    mesh = small_mesh()
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
