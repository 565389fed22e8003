"""The clients' weights, made by the benchmark from the seed.

One ``torch.Generator`` on the device draws every leaf of K stacked
clients in one call each, straight in the leaf's dtype, in a fixed order,
so the same seed on the same kind of device gives the same weights.  The
tree has the layout of the port's ``LMClients.client_params`` (the JAX
package's parameter schema behind a client axis), which the benchmark
hands to the population and the reference reads again.

Distributions (the benchmark's own): matrices N(0, 1) / sqrt(fan-in),
the embedding N(0, 0.02), norm and bias leaves N(0, 0.02) (the model
scales by 1 + w), and Mamba2's per-head A_log = log U(1, 16), D = 1 +
N(0, 0.1), dt_bias = softplus^-1(dt) with dt log-uniform in
[dt_min, dt_max], in fp32.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _n_layers(cfg: dict) -> int:
    return cfg["n_layers"] // len(cfg["period"])


def leaf_specs(cfg: dict, K: int) -> Iterator[Tuple[tuple, tuple, str, str]]:
    """(path, shape, dtype, rule) of every leaf, in the order drawn.  rule
    is "dense:<fan-in>", "embed", "small", "a_log", "d" or "dt_bias"."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], _n_layers(cfg)
    pd = cfg["param_dtype"]
    yield ("embed",), (K, V, d), pd, "embed"
    yield ("final_norm",), (K, d), pd, "small"
    for i, spec in enumerate(cfg["period"]):
        slot = ("periods", f"slot{i}")
        lead = (K, L)
        yield slot + ("norm1",), lead + (d,), pd, "small"
        if spec["mixer"] == "attn":
            H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
            m = slot + ("mixer",)
            yield m + ("w_qkv",), lead + (d, H + 2 * Hkv, hd), pd, f"dense:{d}"
            yield m + ("w_o",), lead + (H, hd, d), pd, f"dense:{H * hd}"
            if cfg.get("qk_norm"):
                yield m + ("q_norm",), lead + (hd,), pd, "small"
                yield m + ("k_norm",), lead + (hd,), pd, "small"
        else:
            s = cfg["ssm"]
            di = s["expand"] * d
            nh = di // s["head_dim"]
            gn = s["n_groups"] * s["d_state"]
            conv_ch = di + 2 * gn
            m = slot + ("mixer",)
            yield m + ("in_proj",), lead + (d, 2 * di + 2 * gn + nh), pd, \
                f"dense:{d}"
            yield m + ("conv_w",), lead + (s["d_conv"], conv_ch), pd, \
                f"dense:{s['d_conv']}"
            yield m + ("conv_b",), lead + (conv_ch,), pd, "small"
            yield m + ("A_log",), lead + (nh,), "float32", "a_log"
            yield m + ("D",), lead + (nh,), "float32", "d"
            yield m + ("dt_bias",), lead + (nh,), "float32", "dt_bias"
            yield m + ("norm",), lead + (di,), pd, "small"
            yield m + ("out_proj",), lead + (di, d), pd, f"dense:{di}"
        if spec["ffn"] == "mlp":
            yield slot + ("norm2",), lead + (d,), pd, "small"
            f = slot + ("ffn",)
            yield f + ("w_gate",), lead + (d, cfg["d_ff"]), pd, f"dense:{d}"
            yield f + ("w_up",), lead + (d, cfg["d_ff"]), pd, f"dense:{d}"
            yield f + ("w_down",), lead + (cfg["d_ff"], d), pd, \
                f"dense:{cfg['d_ff']}"
        elif spec["ffn"] != "none":
            raise ValueError(f"no weights for an ffn {spec['ffn']!r}")
    if not cfg.get("tie_embeddings"):
        yield ("lm_head",), (K, d, V), pd, f"dense:{d}"


def _draw(gen, shape, dtype, rule: str, cfg: dict, device) -> torch.Tensor:
    kw = dict(generator=gen, device=device)
    if rule.startswith("dense:"):
        std = int(rule[6:]) ** -0.5
        return torch.randn(shape, dtype=dtype, **kw).mul_(std)
    if rule in ("embed", "small"):
        return torch.randn(shape, dtype=dtype, **kw).mul_(0.02)
    if rule == "a_log":
        return torch.log(1.0 + 15.0 * torch.rand(shape, dtype=dtype, **kw))
    if rule == "d":
        return 1.0 + 0.1 * torch.randn(shape, dtype=dtype, **kw)
    if rule == "dt_bias":
        s = cfg["ssm"]
        lo, hi = math.log(s["dt_min"]), math.log(s["dt_max"])
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, dtype=dtype, **kw))
        return dt + torch.log(-torch.expm1(-dt))       # softplus^-1(dt)
    raise ValueError(f"unknown rule {rule!r}")


def make_weights(cfg: dict, K: int, seed: int, device) -> dict:
    """The nested tree of K stacked clients' weights on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: dict = {}
    for path, shape, dt, rule in leaf_specs(cfg, K):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _draw(gen, shape, _DT[dt], rule, cfg, device)
    return tree


def leaves(tree, path=()):
    """(path, tensor) of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v
