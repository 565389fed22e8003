"""MusicGen-medium — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

The EnCodec tokenizer/conv codec and the T5 text-conditioning encoder are the
stubbed modality frontend: ``input_specs`` feeds (a) EnCodec token ids in the
2048-entry codebook vocabulary (codebook interleaving via the delay pattern is
a data-layout choice, already applied upstream) and (b) a conditioning prefix
of precomputed text-encoder embeddings.  kv_heads == n_heads (plain MHA).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6_144,
    vocab_size=2_048,
    period=(LayerSpec("attn", "mlp"),),
    prefix_tokens=64,             # conditioning embeddings (stub frontend)
    prefix_dim=768,               # T5-base hidden
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=256, prefix_tokens=8, prefix_dim=48,
        param_dtype="float32", compute_dtype="float32",
    )
