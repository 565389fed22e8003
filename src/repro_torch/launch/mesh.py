"""The meshes of a run (``repro/launch/mesh.py``) and the card's
constants for the roofline (``HardwareSpec``, ``H100``).

  - ``make_production_mesh``: the data x model mesh, (data 16, model 16)
    or (pod 2, data 16, model 16), as a ``torch.distributed`` DeviceMesh
    with named dims over the current process group (one rank a card, or
    the dry-run's fake process group of that world size);
  - ``make_cpu_mesh`` / ``make_card_mesh``: a small data x model mesh of
    CPU ranks (the tests' gloo ranks) or of card ranks;
  - ``make_client_mesh`` and ``parse_mesh_spec``: the client mesh
    (``sharding.ClientMesh``, one process).

Each DeviceMesh builder raises when no process group of the mesh's size
is initialised, rather than building a smaller mesh.  The JAX module's
``V5E`` numbers are a TPU's and are not carried over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.sharding import CLIENT_AXIS, ClientMesh


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_mesh(shape, axes, device_type: str):
    """A DeviceMesh of ``shape`` with dims named ``axes`` over the default
    process group, which must hold exactly prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {dict(zip(axes, shape))} mesh needs a "
                           f"process group of {n} ranks; none is "
                           "initialised")
    if dist.get_world_size() != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
    for dims in flat_dims(mesh):
        mesh[dims]._flatten("_".join(dims))
    return mesh


def flat_dims(mesh) -> list:
    """The runs of two or more adjacent mesh dims, each flattened into a
    dim of its own ("pod_data", "data_model", ...): DTensor then reduces a
    partial sum over several dims in one collective over their union, as
    XLA does, rather than one dim after another."""
    names = tuple(mesh.mesh_dim_names)
    return [names[i:j] for i in range(len(names))
            for j in range(i + 2, len(names) + 1)]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """single-pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2,
    data=16, model=16) = 512 ranks.  ``device_type`` "cpu" serves the
    dry-run's fake process group, whose tensors are on the meta device."""
    shape, axes = PRODUCTION[multi_pod]
    return _device_mesh(shape, axes, device_type)


def make_cpu_mesh(shape=(2, 2), axes=("data", "model")):
    """Small data x model mesh of CPU ranks (gloo) for tests."""
    return _device_mesh(shape, axes, "cpu")


def make_card_mesh(shape=(2, 2), axes=("data", "model")):
    """Small data x model mesh of ranks on the cards: NCCL, one card a
    rank.  Over gloo (ranks sharing one card, which NCCL refuses) DTensor's
    functional collectives of CUDA tensors crash in ``wait_tensor``; a
    caller that shares a card runs them itself first, as ``chip_smoke.py``
    does (card to card through CUDA IPC)."""
    return _device_mesh(shape, axes, "cuda")


def make_client_mesh(n_devices: int = 0, device=None) -> ClientMesh:
    """1-D ``clients`` mesh over the first n devices (0 -> all available).

    On CUDA (``device=None`` means CUDA, as at every entry point) its
    entries are the first n cards; more than the visible cards raise.  On
    the CPU (``device="cpu"``) it is n entries of the CPU (one for 0).  A
    mesh that repeats a device, such as two entries of one card, is built
    with ``ClientMesh`` directly.  The federated engines shard whole
    clients over it; K > n_devices spills round-robin
    (``core.stacking.client_layout``).
    """
    device = ops.resolve_device(device)
    if device.type == "cpu":
        return ClientMesh((device,) * max(n_devices, 1))
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(
            f"mesh wants {n} devices but only {count} are visible; a mesh "
            f"that repeats one card is ClientMesh(('cuda:0',) * {n})")
    return ClientMesh(tuple(torch.device("cuda", i) for i in range(n)),
                      (CLIENT_AXIS,))


def parse_mesh_spec(spec: str) -> dict:
    """'clients=4' / 'clients=4,data=2' -> {'clients': 4, 'data': 2}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, num = part.partition("=")
        if not num.isdigit():
            raise ValueError(f"bad mesh spec {spec!r}: expected axis=N")
        out[name.strip()] = int(num)
    return out


@dataclass(frozen=True)
class HardwareSpec:
    """One card's peaks for the roofline (``analysis.roofline``), with the
    JAX class's field names: dense FLOP/s a card by dtype, HBM bytes/s,
    the link's bytes/s one way (``ici_bandwidth``: the term JAX gives the
    TPU's inter-chip link) and the card's memory."""
    name: str
    peak_flops_bf16: float
    peak_flops_tf32: float
    peak_flops_fp32: float
    hbm_bandwidth: float
    ici_bandwidth: float
    hbm_bytes: int


# NVIDIA's published dense peaks of one H100 SXM at its 700 W limit: bf16
# and TF32 on the tensor cores, fp32 without them, HBM3, and one direction
# of NVLink 4 (900 GB/s both ways).  The one source of the card's numbers.
H100 = HardwareSpec(name="h100_sxm", peak_flops_bf16=989e12,
                    peak_flops_tf32=495e12, peak_flops_fp32=67e12,
                    hbm_bandwidth=3.35e12, ici_bandwidth=450e9,
                    hbm_bytes=80 * 10 ** 9)
