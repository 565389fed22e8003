"""The whole step's share of the cards' bf16 peak over the traced run's
unprofiled stretch: model FLOPs per round (``yard.work.model_flops``:
6 x matmul parameters x tokens, attention's causal pairs or the SSD's
work, forward and backward, no recompute) x rounds / (seconds x peak x
cards)."""
from portbench.yard import peaks, work

LAYER = "device"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ()


def read(ctx):
    if not ctx.unprofiled_rounds or ctx.unprofiled_s <= 0:
        return None
    tr = ctx.cell["traffic"]
    flops = work.model_flops(ctx.cell["config"]["model"],
                             tr["clients"] * (tr["batch"]
                                              + tr["public_batch"]),
                             tr["seq"])
    return 100.0 * flops * ctx.unprofiled_rounds / (
        ctx.unprofiled_s * peaks.BF16_FLOPS * len(ctx.trace.devices))
