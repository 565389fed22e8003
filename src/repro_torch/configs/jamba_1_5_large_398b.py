"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE every
2nd layer, 16 experts top-2 [arXiv:2403.19887].

Period of 8 layers: attention at slot 4 (as in the Jamba paper's block),
Mamba elsewhere; MoE on odd slots (e=2), dense SwiGLU on even slots.
"""
from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                      SSMConfig)


def _period():
    slots = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        slots.append(LayerSpec(mixer, ffn))
    return tuple(slots)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    period=_period(),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24_576),
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, chunk=256),
    long_context_variant="native",   # only 9/72 layers are attention
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=256),
        ssm=SSMConfig(d_state=16, head_dim=32, chunk=32),
        param_dtype="float32", compute_dtype="float32",
    )
