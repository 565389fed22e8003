"""Mamba2 block (SSD): train/prefill forward and single-step decode, over a
written-out client axis (``repro/models/ssm.py``).

Block layout follows the Mamba2 paper: fused in_proj -> (z, xBC, dt),
causal depthwise conv over xBC, SiLU, SSD scan over heads, D skip, gated
RMSNorm, out_proj.  Activations are (K, B, S, ...) and weights (K, ...),
the JAX package's layouts behind a client axis.  ``A_log``, ``D`` and
``dt_bias`` are fp32 leaves in a tree of the param dtype, as in JAX.

For the scan the K clients become heads (``ops.ssd_clients``): x
(K, B, S, H, P) is laid out as (B, S, K*H, P) and B/C as (B, S, K*G, N),
so head k*H + h reads group k*G + h // (H/G) and A (K*H,) carries each
client's own decay rates; one kernel launch then serves the whole
population.  Decode carries (conv
state, ssm state) -- constant size -- and updates the cache IN PLACE.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, gated_rms_norm, matmul,
                                       per_client)
from repro_torch.sharding import constrain
from repro_torch.sharding.local import (elementwise, keep_shards, local_call,
                                        replicated)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()):
    """The JAX distributions: truncated-normal in/out projections and conv
    (scale d_conv**-0.5), dt log-uniform in [dt_min, dt_max] stored as
    softplus^-1(dt), A_log = log(1..nh), D = 1, zero conv bias and norm."""
    s, di, nh, conv_ch = _dims(cfg)
    d_in_proj = 2 * di + 2 * s.n_groups * s.d_state + nh
    dev = gen.device
    u = (torch.empty(lead + (nh,), device=dev) if dev.type == "meta"
         else torch.rand(lead + (nh,), generator=gen, device=dev))
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))       # softplus^-1(dt)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (cfg.d_model, d_in_proj), cfg.pdtype(),
                              lead=lead),
        "conv_w": dense_init(gen, (s.d_conv, conv_ch), cfg.pdtype(),
                             scale=s.d_conv ** -0.5, lead=lead),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=cfg.pdtype(),
                              device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)).expand(
            lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": dt_bias,
        "norm": torch.zeros(lead + (di,), dtype=cfg.pdtype(), device=dev),
        "out_proj": dense_init(gen, (di, cfg.d_model), cfg.pdtype(),
                               lead=lead),
    }


def mamba_logical_axes(cfg: ModelConfig):
    """Logical axes of ``init_mamba``'s leaves
    (``repro/models/ssm.py:50-60``)."""
    return {
        "in_proj": ("embed", "ff"),
        "conv_w": ("conv", None),
        "conv_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": ("ff",),
        "out_proj": ("ff", "embed"),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    s, di, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv in xBC's dtype, the JAX package's shifted sum
    term by term.  xBC: (K, B, S, C); w: (K, d_conv, C); b: (K, C).  A
    DTensor xBC runs on each rank's (client, batch) shard
    (``_conv_local``)."""
    if isinstance(xBC, DTensor):
        return _conv_local(xBC, w, b)
    Kc, S = w.shape[1], xBC.shape[2]
    pad = F.pad(xBC, (0, 0, Kc - 1, 0))
    out = pad[:, :, 0:S] * per_client(w[:, 0], xBC)
    for i in range(1, Kc):
        out = out + pad[:, :, i:i + S] * per_client(w[:, i], xBC)
    return out + per_client(b, xBC)


def _conv_local(xBC, w, b):
    """``_causal_conv`` of a DTensor xBC on each rank's (client, batch)
    shard, the sequence and the channels whole (PyTorch 2.11's DTensor
    fails to redistribute the input of its ``pad`` rule here).  The conv
    weights are read whole but for their client shard; their gradients
    are partial sums over a batch split."""
    mesh = xBC.device_mesh
    w, b = replicated(w, mesh), replicated(b, mesh)
    xp = keep_shards(xBC, {0, 1})
    wp = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in xp]
    wg = [Partial() if isinstance(p, Shard) and p.dim == 1 else q
          for p, q in zip(xp, wp)]
    return local_call(_causal_conv, xp, (xp, wp, wp), mesh, xBC, w, b,
                      grad_placements=(xp, wg, wg))


def mamba_forward(params, cfg: ModelConfig, u, return_state: bool = False,
                  *, impl: str):
    """u: (K, B, S, d) -> y (K, B, S, d) [, (conv_state (K, B, d_conv-1,
    conv_ch), ssm_state (K, B, nh, P, N) fp32)].  ``impl`` is the SSD
    kernel impl the caller resolved (``kernels.ops``)."""
    s, di, nh, conv_ch = _dims(cfg)
    K, B, S, _ = u.shape
    zxbcdt = constrain(matmul(u, params["in_proj"]), "client", "batch",
                       "seq", "ff")
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC_act = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    gn = s.n_groups * s.d_state
    x = xBC_act[..., :di].reshape(K, B, S, nh, s.head_dim)
    Bm = xBC_act[..., di: di + gn].reshape(K, B, S, s.n_groups, s.d_state)
    Cm = xBC_act[..., di + gn:].reshape(K, B, S, s.n_groups, s.d_state)
    # x stays head-sharded; the small B/C group projections replicate
    Bm = constrain(Bm, "client", "batch", "seq", None, None)
    Cm = constrain(Cm, "client", "batch", "seq", None, None)
    dt = elementwise(F.softplus,
                         dt.float() + per_client(params["dt_bias"], dt))
    A = -torch.exp(params["A_log"])
    x = constrain(x, "client", "batch", "seq", "heads", None)
    y, state = ops.ssd_clients(x, dt, A, Bm, Cm, chunk=s.chunk, impl=impl)
    y = y + params["D"].to(y.dtype)[:, None, None, :, None] * x
    y = y.reshape(K, B, S, di)
    y = gated_rms_norm(y, z, per_client(params["norm"], y), cfg.rms_eps)
    out = matmul(y, params["out_proj"])
    if not return_state:
        return out
    conv_state = xBC[:, :, S - (s.d_conv - 1):] if S >= s.d_conv - 1 else \
        F.pad(xBC, (0, 0, s.d_conv - 1 - S, 0))
    return out, (conv_state.to(cfg.cdtype()), state)


# ---------------------------------------------------------------------------
# decode

def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                     lead: Tuple[int, ...] = (), device):
    """Constant-size decode state of one Mamba layer; ``lead`` prepends
    stacking axes (clients, layers)."""
    s, di, nh, conv_ch = _dims(cfg)
    dtype = dtype or cfg.cdtype()
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_cache_logical_axes():
    return {"conv": ("batch", None, "ff"),
            "ssm": ("batch", "heads", None, "state")}


def mamba_decode(params, cfg: ModelConfig, u, cache):
    """One token: u (K, B, 1, d); cache {"conv": (K, B, d_conv-1, conv_ch),
    "ssm": (K, B, nh, P, N) fp32}, updated IN PLACE.  The conv runs in fp32
    before the SiLU here, unlike prefill's (``repro/models/ssm.py:137-166``).
    Returns (y (K, B, 1, d), cache)."""
    s, di, nh, conv_ch = _dims(cfg)
    K, B = u.shape[:2]
    zxbcdt = matmul(u, params["in_proj"])
    z, xBC, dt = _split_proj(cfg, zxbcdt)                  # (K,B,1,*)
    window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=2)
    conv_out = torch.einsum("kbtc,ktc->kbc", window.float(),
                            params["conv_w"].float()) \
        + params["conv_b"].float()[:, None]
    xBC_act = F.silu(conv_out)[:, :, None, :].to(u.dtype)  # (K,B,1,C)
    gn = s.n_groups * s.d_state
    x = xBC_act[..., :di].reshape(K, B, nh, s.head_dim)
    Bm = xBC_act[..., di: di + gn].reshape(K, B, s.n_groups, s.d_state)
    Cm = xBC_act[..., di + gn:].reshape(K, B, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    Bh = Bm.repeat_interleave(rep, dim=2).float()          # (K,B,nh,N)
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    dtv = F.softplus(dt[:, :, 0].float() + params["dt_bias"][:, None])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dtv * A[:, None])                    # (K,B,nh)
    xf = x.float()
    ssm = cache["ssm"] * decay[..., None, None] + \
        torch.einsum("kbhn,kbhp,kbh->kbhpn", Bh, xf, dtv)
    y = torch.einsum("kbhn,kbhpn->kbhp", Ch, ssm) \
        + params["D"][:, None, :, None] * xf
    y = y.reshape(K, B, 1, di).to(u.dtype)
    y = gated_rms_norm(y, z, per_client(params["norm"], y), cfg.rms_eps)
    out = matmul(y, params["out_proj"])
    cache["conv"].copy_(window[:, :, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
