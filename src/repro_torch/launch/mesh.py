"""The client mesh of a run (``repro/launch/mesh.py``'s
``make_client_mesh`` and ``parse_mesh_spec``) and the card's constants for
the roofline (``HardwareSpec``, ``H100``).

The JAX module's production meshes describe a TPU pod and are not ported
yet (the data x model slice); its ``V5E`` numbers are a TPU's and are not
carried over.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import CLIENT_AXIS, ClientMesh


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
