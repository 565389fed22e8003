"""Device kernel launches per profiled round, summed over the cards
(copies and sets are not kernels)."""
LAYER = "step: core/distributed.py, optim/__init__.py adamw_update"
UNIT = "kernels"
MOVES = "train_tok_s"
KERNELS = ()


def read(ctx):
    n = sum(a.is_kernel for a in ctx.trace.in_rounds())
    return n / ctx.trace.n_rounds if n else None
