"""Qwen3-8B — dense, qk-norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab_size=151_936,
    qk_norm=True,
    period=(LayerSpec("attn", "mlp"),),
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
    )
