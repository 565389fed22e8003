"""Qwen1.5-110B — dense, QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49_152,
    vocab_size=152_064,
    qkv_bias=True,
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
