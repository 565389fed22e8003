"""The share of the profiled rounds' stretch in which a card ran nothing,
averaged over the cards: 1 - the union of its activities / the stretch."""
from portbench.yard import trace as T

LAYER = "device"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ()


def read(ctx):
    tr = ctx.trace
    span = tr.end - tr.start
    if span <= 0:
        return None
    idle = [1 - T.busy_us(tr, d) / span for d in tr.devices]
    return 100.0 * sum(idle) / len(idle)
