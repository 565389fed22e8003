"""Mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                       # mamba2 blocks carry no MLP
    vocab_size=50_280,
    period=(LayerSpec("mamba", "none"),),
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, chunk=256),
    long_context_variant="native",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=32, chunk=32),
        param_dtype="float32", compute_dtype="float32",
    )
