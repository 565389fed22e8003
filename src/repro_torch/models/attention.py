"""GQA attention block: prefill/forward self-attention and ring-buffer
KV-cache decode, over a written-out client axis.

Activations are (K, B, S, ...) and weights (K, ...): w_qkv (K, d, n_qkv, hd),
w_o (K, H, hd, d), the JAX package's layouts behind a client axis.  For the
kernel the client axis is folded into the batch: self-attention runs on
(K*B, S, H, hd).  The KV cache is a ring buffer of min(max_seq, window)
entries holding absolute positions (unwritten entries are -1), so RoPE'd
keys stay valid after wrap-around.  Cache writes are IN PLACE: the cache
dict passed in is updated and returned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, matmul,
                                       per_client, rms_norm)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()):
    hd = cfg.head_dim_
    n_qkv = cfg.n_heads + 2 * cfg.n_kv_heads
    p = {
        "w_qkv": dense_init(gen, (cfg.d_model, n_qkv, hd), cfg.pdtype(),
                            lead=lead),
        "w_o": dense_init(gen, (cfg.n_heads, hd, cfg.d_model), cfg.pdtype(),
                          scale=(cfg.n_heads * hd) ** -0.5, lead=lead),
    }
    zeros = dict(dtype=cfg.pdtype(), device=gen.device)
    if cfg.qkv_bias:
        p["b_qkv"] = torch.zeros(lead + (n_qkv, hd), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), **zeros)
        p["k_norm"] = torch.zeros(lead + (hd,), **zeros)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x (K, B, S, d) -> q (K, B, S, H, hd), k and v (K, B, S, Hkv, hd);
    positions (B, S) are shared by the clients.  v is a view of the fused
    projection."""
    K, d = x.shape[0], x.shape[-1]
    w = params["w_qkv"]
    qkv = matmul(x, w.reshape(K, d, -1)).unflatten(-1, w.shape[-2:])
    if cfg.qkv_bias:
        qkv = qkv + params["b_qkv"][:, None, None]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = qkv[..., :H, :]
    k = qkv[..., H:H + Hkv, :]
    v = qkv[..., H + Hkv:, :]
    if cfg.qk_norm:
        q = rms_norm(q, per_client(params["q_norm"], q), cfg.rms_eps)
        k = rms_norm(k, per_client(params["k_norm"], k), cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, w_o):
    """(K, B, S, H, hd) x (K, H, hd, d) -> (K, B, S, d)."""
    K, H, hd, d = w_o.shape
    return matmul(out.flatten(-2), w_o.reshape(K, H * hd, d))


def _self_attention(q, k, v, window: Optional[int], impl: str):
    """Causal self-attention with the client axis folded into the batch."""
    out = ops.attention(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1),
                        causal=True, window=window, impl=impl)
    return out.unflatten(0, q.shape[:2])


def attention_forward(params, cfg: ModelConfig, x, positions=None, *,
                      window: Optional[int] = None, impl: str):
    """Self-attention over x (K, B, S, d).  window=None -> cfg.sliding_window;
    ``impl`` is the kernel impl the caller resolved (``kernels.ops``)."""
    _, B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if window is None:
        window = cfg.sliding_window
    q, k, v = _project_qkv(params, cfg, x, positions)
    return _out_proj(_self_attention(q, k, v, window, impl), params["w_o"])


# ---------------------------------------------------------------------------
# KV cache (decode)

def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: Optional[int] = None, dtype=None, *,
                  lead: Tuple[int, ...] = (), device):
    """Ring-buffer cache for one attention layer; ``lead`` prepends
    stacking axes (clients, layers)."""
    dtype = dtype or cfg.cdtype()
    size = max_seq if window is None else min(window, max_seq)
    shape = lead + (batch, size, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def attention_decode(params, cfg: ModelConfig, x, cache, pos,
                     window: Optional[int] = None):
    """One-token decode.  x: (K, B, 1, d); cache: {"k", "v": (K, B, size,
    Hkv, hd), "pos": (K, B, size)}; pos: an int (tokens so far) or a (B,)
    tensor of per-sequence positions (the serving arena).

    Writes the new key/value into the cache in place and returns
    (y (K, B, 1, d), cache).  Attention against the cache takes the plain
    version (explicit positions).
    """
    K, B = x.shape[:2]
    if window is None:
        window = cfg.sliding_window
    pos = torch.as_tensor(pos, device=x.device)
    positions = (pos if pos.dim() == 1 else pos.expand(B))[:, None].long()
    q, k, v = _project_qkv(params, cfg, x, positions)

    size = cache["k"].shape[2]
    slot = positions[:, 0] % size
    bidx = torch.arange(B, device=x.device)
    cache["k"][:, bidx, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, bidx, slot] = v[:, :, 0].to(cache["v"].dtype)
    cache["pos"][:, bidx, slot] = positions[:, 0].to(torch.int32)

    flat = lambda t: t.reshape(K * B, *t.shape[2:])     # noqa: E731
    out = ops.attention(
        flat(q), flat(cache["k"]), flat(cache["v"]), causal=True,
        window=window, positions_q=positions.expand(K, B, 1).reshape(K * B, 1),
        positions_k=flat(cache["pos"]))
    return _out_proj(out.unflatten(0, (K, B)), params["w_o"]), cache


def attention_prefill(params, cfg: ModelConfig, x, cache, *,
                      window: Optional[int] = None, impl: str):
    """Prompt ingestion: causal self-attention through ``impl`` plus the
    cache write.  x: (K, B, S, d); cache as in ``attention_decode``, filled
    in place with the last ``size`` positions (a prompt longer than the
    ring rolls its tail in, slot of position p = p % size).
    Returns (y (K, B, S, d), cache)."""
    _, B, S, _ = x.shape
    if window is None:
        window = cfg.sliding_window
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, cfg, x, positions)
    y = _out_proj(_self_attention(q, k, v, window, impl), params["w_o"])

    size = cache["k"].shape[2]
    if S >= size:
        shift = (S - size) % size
        roll = lambda t: torch.roll(t, shifts=shift, dims=2)  # noqa: E731
        cache["k"].copy_(roll(k[:, :, S - size:]))
        cache["v"].copy_(roll(v[:, :, S - size:]))
        cache["pos"].copy_(roll(positions[None, :, S - size:]))
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        cache["pos"][:, :, :S] = positions
    return y, cache
