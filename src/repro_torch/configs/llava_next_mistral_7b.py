"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower (CLIP-ViT-L/336 + 2-layer MLP projector, anyres tiling up to
5 tiles x 576 patches) is the stubbed modality frontend: ``input_specs`` feeds
precomputed patch embeddings of shape (B, prefix_tokens, prefix_dim) and the
backbone owns only the projector + decoder.  Mistral-7B uses native sliding-
window attention (4096), so long_500k runs natively sub-quadratic.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    sliding_window=4096,          # mistral-7B-v0.1 native SWA
    period=(LayerSpec("attn", "mlp"),),
    rope_theta=10_000.0,
    prefix_tokens=2880,           # anyres: 5 tiles x 576 patches
    prefix_dim=1024,              # CLIP-ViT-L hidden
    long_context_variant="native",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, sliding_window=64,
        prefix_tokens=16, prefix_dim=48,
        param_dtype="float32", compute_dtype="float32",
    )
