"""Attention's work at the card's bound over the device time of the flash
kernels (``csrc/flash_attention_*.cu``): per attention layer one causal
call on the private batch and one on the public, forward and backward,
each layer's forward counted once (remat's recompute is not)."""
from portbench.yard import trace as T
from portbench.yard import work

LAYER = "kernels: models/attention.py, kernels/flash_attention.py"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("attn_fwd", "attn_fwd_tc", "attn_bwd_delta", "attn_bwd_dkdv",
           "attn_bwd_dq", "attn_bwd_delta_tc", "attn_bwd_dkdv_tc",
           "attn_bwd_dq_tc")


def read(ctx):
    cfg, tr = ctx.cell["config"]["model"], ctx.cell["traffic"]
    n_attn = sum(s["mixer"] == "attn" for s in cfg["period"]) \
        * (cfg["n_layers"] // len(cfg["period"]))
    secs = T.device_seconds(ctx.trace, KERNELS)
    if not n_attn or secs <= 0:
        return None
    heads = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"])
    k_loc = -(-tr["clients"] // tr["cards"])
    bound = tr["cards"] * n_attn * sum(
        work.attention_bound_s(k_loc * b, tr["seq"], *heads)
        for b in (tr["batch"], tr["public_batch"]))
    return 100.0 * bound * ctx.trace.n_rounds / secs
