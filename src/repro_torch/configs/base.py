"""Model/config dataclasses, the port's own copy of ``repro/configs/base.py``.

A ``ModelConfig`` fully describes one decoder backbone: geometry, the
per-period layer program, MoE/SSM sub-configs and the modality frontend
stub.  The fields are the JAX package's, so a checkpoint's config means the
same here; ``pdtype()``/``cdtype()`` return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# ---------------------------------------------------------------------------
# sub-configs


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN config (capacity-based top-k routing)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden size
    n_shared_experts: int = 0     # always-on shared experts (qwen2-moe style)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3   # router z-loss (Zoph et al.)
    aux_coef: float = 1e-2        # load-balance aux loss


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head dim (P)
    n_groups: int = 1             # B/C groups
    chunk: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LayerSpec:
    """One slot in the per-period layer program."""

    mixer: str                    # 'attn' | 'mamba'
    ffn: str                      # 'mlp' | 'moe' | 'none'


# ---------------------------------------------------------------------------
# main config


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                     # dense-MLP hidden (0 if none / pure MoE)
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention features
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # native SWA (tokens)
    rope_theta: float = 10_000.0
    # layer program: one period, tiled n_layers // len(period) times
    period: Tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # modality frontend stub: number of prefix embedding tokens
    prefix_tokens: int = 0
    prefix_dim: int = 0
    long_context_variant: str = "sliding_window"
    long_context_window: int = 8192
    # norms / misc
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # dtypes (strings so the dataclass stays hashable)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # -- derived ----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period {len(self.period)}")
        return self.n_layers // len(self.period)

    @property
    def attn_free(self) -> bool:
        return all(s.mixer != "attn" for s in self.period)

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (used by the comm accounting) ----------
    def param_count(self) -> int:
        """Exact parameter count of the backbone built by the JAX package's
        ``models/transformer.py``."""
        d, hd = self.d_model, self.head_dim_
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        n += d                                          # final norm
        for spec in self.period:
            ln = 0
            ln += d                                     # pre-mixer norm
            if spec.mixer == "attn":
                qkv_out = (self.n_heads + 2 * self.n_kv_heads) * hd
                ln += d * qkv_out
                if self.qkv_bias:
                    ln += qkv_out
                if self.qk_norm:
                    ln += 2 * hd
                ln += self.n_heads * hd * d             # o_proj
            else:  # mamba
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_ch = di + 2 * s.n_groups * s.d_state
                ln += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                ln += s.d_conv * conv_ch + conv_ch      # conv1d w+b
                ln += nh                                # A_log
                ln += nh                                # D
                ln += nh                                # dt_bias
                ln += di                                # ssd norm (gated rmsnorm)
                ln += di * d                            # out_proj
            if spec.ffn != "none":
                ln += d                                 # pre-ffn norm
            if spec.ffn == "mlp":
                ln += 3 * d * self.d_ff                 # swiglu
            elif spec.ffn == "moe":
                m = self.moe
                ln += d * m.n_experts                   # router
                ln += m.n_experts * 3 * d * m.d_expert
                if m.n_shared_experts:
                    ln += 3 * d * (m.n_shared_experts * m.d_expert)
            n += ln * self.n_periods
        if self.prefix_tokens:
            n += self.prefix_dim * d + d               # projector
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for s in self.period
                           if s.ffn == "moe") * self.n_periods
        per_expert = 3 * self.d_model * m.d_expert
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# input shapes


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
