"""Shared building blocks: RMSNorm (plain and gated), RoPE, SwiGLU MLP, init.

The port writes the stacked client axis out: model weights carry a leading
client axis K and activations are (K, B, S, ...), so one batched product
serves every client (``matmul``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.sharding import constrain
from repro_torch.sharding.local import replicated, sharded_matmul


# ---------------------------------------------------------------------------
# init helpers

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: the init helpers draw nothing there and return tensors of the
    right shapes and dtypes without storage (the dry-run)."""
    device = torch.device("meta")


def make_generator(seed: int, device: torch.device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; on the meta
    device a ``MetaGenerator``."""
    if device.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def _stacked(lead: Tuple[int, ...], shape: Tuple[int, ...], dtype, device,
             draw) -> torch.Tensor:
    """A (lead + shape) tensor of ``dtype`` filled one ``shape`` slice at a
    time (per client and layer): ``draw(t)`` fills an fp32 slice in place,
    which is then cast into the output.  The fp32 temporary is one slice,
    never the whole stacked leaf (a qwen2-moe expert leaf of two clients is
    33 GB in fp32).  On the meta device nothing is drawn."""
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    if out.is_meta:
        return out
    flat = out.view(-1, *shape)
    tmp = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    for i in range(flat.shape[0]):
        flat[i].copy_(draw(tmp))
    return out


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    """Truncated-normal fan-in init (LeCun-style): std * N(0, 1) cut to
    [-2, 2], std = fan_in ** -0.5 with fan_in = ``shape[0]`` (the JAX
    rule: an (E, d, de) expert leaf gets E ** -0.5).  ``lead`` prepends
    stacking axes (clients, layers) that do not count towards the
    fan-in."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _stacked(lead, shape, dtype, gen.device, lambda t: (
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        .mul_(std)))


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               lead: Tuple[int, ...] = ()):
    return _stacked(lead, shape, dtype, gen.device, lambda t: (
        t.normal_(0.0, 1.0, generator=gen).mul_(0.02)))


# ---------------------------------------------------------------------------
# stacked-client products

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, ..., d) @ (K, d, f) -> (K, ..., f): one batched product over the
    client axis.  Mixed dtypes promote, as ``jnp`` einsum/matmul do.  On a
    mesh, a rank's product on its shards (``sharding.local.sharded_matmul``)."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        mesh = (x if isinstance(x, DTensor) else w).device_mesh
        return sharded_matmul(replicated(x, mesh), replicated(w, mesh))
    dt = torch.promote_types(x.dtype, w.dtype)
    K = x.shape[0]
    out = torch.matmul(x.reshape(K, -1, x.shape[-1]).to(dt), w.to(dt))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def per_client(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (K, ..., n) per-client vector viewed to broadcast against
    x (K, ..., n): (K, 1, ..., 1, n)."""
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


# ---------------------------------------------------------------------------
# norms

def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm in fp32 scaling by ``1 + weight`` (zero-init weights), as
    ``repro/models/layers.py:29-34``; ``weight`` broadcasts against x."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def gated_rms_norm(x, gate, weight, eps: float = 1e-5):
    """Mamba2's norm(x * silu(z)) fused gate (``repro/models/layers.py:37-40``):
    the gate's SiLU in fp32, cast to x's dtype before the product."""
    return rms_norm(x * F.silu(gate.float()).to(x.dtype), weight, eps)


# ---------------------------------------------------------------------------
# rotary embeddings

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-halves RoPE with fp32 angles.  x: (..., S, H, hd);
    positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             lead: Tuple[int, ...] = ()):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
    }


def mlp_logical_axes():
    return {
        "w_gate": ("embed", "ff"),
        "w_up": ("embed", "ff"),
        "w_down": ("ff", "embed"),
    }


def apply_mlp(params, x):
    """x (K, ..., d) with per-client weights (K, d, d_ff) / (K, d_ff, d)."""
    h = F.silu(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    h = constrain(h, "client", "batch", "seq", "ff")
    return matmul(h, params["w_down"])
