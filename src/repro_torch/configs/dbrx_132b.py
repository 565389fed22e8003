"""DBRX-base 132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,                       # pure-MoE FFN
    vocab_size=100_352,
    period=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10_752),
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    """Smoke-test variant: same family/features, tiny geometry."""
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=160),
        param_dtype="float32", compute_dtype="float32",
    )
