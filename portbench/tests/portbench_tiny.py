"""Tiny cells of the benchmark's two configurations for the CPU tests:
the widths cut to what a test run holds, bf16 as the cells run."""
from portbench import check

LIMITS = {"ce_gap": 5e-4, "kl_gap": 3e-3, "grad_gap": 1.5e-2,
          "grad_gap_median": 2.5e-3, "update_gap": 2e-2}


def model(mixer: str) -> dict:
    if mixer == "attn":
        return {"name": "qwen3-4b", "family": "dense", "n_layers": 2,
                "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                "head_dim": 16, "d_ff": 128, "vocab_size": 256,
                "qk_norm": True, "rope_theta": 1e6,
                "period": [{"mixer": "attn", "ffn": "mlp"}],
                "tie_embeddings": True, "rms_eps": 1e-6,
                "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    return {"name": "mamba2-780m", "family": "ssm", "n_layers": 2,
            "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
            "vocab_size": 256, "period": [{"mixer": "mamba", "ffn": "none"}],
            "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16,
                    "n_groups": 1, "chunk": 16, "dt_min": 0.001,
                    "dt_max": 0.1},
            "tie_embeddings": True, "rms_eps": 1e-5,
            "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def cell(mixer: str = "attn", clients: int = 3, cards: int = 1) -> dict:
    tr = {"strategy": "dml", "kl_weight": 1.0,
          "participation": "full", "loop": "closed", "clients": clients,
          "batch": 2, "public_batch": 1, "seq": 32, "cards": cards,
          "lr": 1e-3, "warmup": 5, "rounds": 10000, "clip_norm": 1.0}
    assert set(LIMITS) == set(check.NUMBERS)
    return {"name": f"tiny-{mixer}", "config": {"model": model(mixer)},
            "traffic": tr, "chips": 1, "limits": dict(LIMITS)}
