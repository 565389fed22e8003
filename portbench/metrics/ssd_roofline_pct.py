"""The SSD scan's work at the card's bound over the device time of its
kernels (``csrc/ssd_scan_*.cu``, ``ssd_tc.cuh``): per Mamba2 layer one
scan on the private batch and one on the public, the K clients as heads
(x (B, S, K H, P), B and C (B, S, K G, N)), forward and backward."""
from portbench.yard import trace as T
from portbench.yard import work

LAYER = "kernels: models/ssm.py, kernels/ssd_scan.py"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("ssd_fwd", "chunk_out", "chunk_state", "state_pass", "ssd_bwd",
           "ssd_reduce_heads", "bwd_heads", "bwd_group", "bwd_ddt")


def read(ctx):
    cfg, tr = ctx.cell["config"]["model"], ctx.cell["traffic"]
    n_ssd = sum(s["mixer"] == "mamba" for s in cfg["period"]) \
        * (cfg["n_layers"] // len(cfg["period"]))
    secs = T.device_seconds(ctx.trace, KERNELS)
    if not n_ssd or secs <= 0:
        return None
    s = cfg["ssm"]
    nh = s["expand"] * cfg["d_model"] // s["head_dim"]
    k = -(-tr["clients"] // tr["cards"])
    bound = tr["cards"] * n_ssd * sum(
        work.ssd_bound_s(b, tr["seq"], k * nh, s["head_dim"],
                         k * s["n_groups"], s["d_state"], s["chunk"])
        for b in (tr["batch"], tr["public_batch"]))
    return 100.0 * bound * ctx.trace.n_rounds / secs
