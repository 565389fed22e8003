"""Host syncs a round: the program's ``host_sync`` counter over its
``round`` counter (``repro_torch.trace.counts``, both kept over every round
the process ran: each device-to-host read, each synchronous copy of a
batch to the card).  Read from the program, not from the trace, and silent
where the program keeps no such counters."""
import importlib

LAYER = "session: core/api.py Federation, core/populations/lm.py LMClients"
UNIT = "syncs"
MOVES = "train_tok_s"
KERNELS = ()


def program_counts() -> dict:
    """The program's counters, or {} where it keeps none."""
    try:
        return dict(importlib.import_module("repro_torch.trace").counts)
    except ModuleNotFoundError:
        return {}


def read(ctx):
    c = program_counts()
    n, rounds = c.get("host_sync"), c.get("round")
    if n is None or not rounds:
        return None
    return n // rounds if n % rounds == 0 else n / rounds
