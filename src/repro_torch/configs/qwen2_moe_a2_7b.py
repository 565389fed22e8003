"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                       # pure-MoE FFN (shared experts cover dense path)
    vocab_size=151_936,
    qkv_bias=True,                # qwen1.5 lineage keeps QKV bias
    period=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared_experts=4),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, n_shared_experts=1),
        param_dtype="float32", compute_dtype="float32",
    )
