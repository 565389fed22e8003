"""The client mesh of a run (``repro/launch/mesh.py``'s
``make_client_mesh`` and ``parse_mesh_spec``).

The JAX module's production meshes and hardware constants describe a TPU
pod and are not ported.
"""
from __future__ import annotations

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
