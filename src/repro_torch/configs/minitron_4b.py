"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9_216,
    vocab_size=256_000,
    period=(LayerSpec("attn", "mlp"),),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=120, n_heads=3, n_kv_heads=1, head_dim=40,
        d_ff=256, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
    )
