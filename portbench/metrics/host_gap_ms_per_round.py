"""Device idle time a round while the session's host work holds the card
back: idle time that falls inside a ``private_batch`` or ``public_batch``
span (``LMClients``' draws) or between two rounds (from one profiled
round's last device activity to the next's first), per round, averaged
over the cards."""
from portbench.yard import trace as T

LAYER = "session: core/api.py Federation, core/populations/lm.py LMClients"
UNIT = "ms"
MOVES = "train_tok_s"
KERNELS = ()
SPANS = (T.SPAN_PREFIX + "private_batch", T.SPAN_PREFIX + "public_batch")


def read(ctx):
    tr = ctx.trace
    edges = []
    for s, e in tr.rounds:
        acts = [a for a in tr.activities if s <= a.start <= e]
        if not acts:
            return None
        edges.append((min(a.start for a in acts), max(a.end for a in acts)))
    host = [(cur[1], nxt[0]) for cur, nxt in zip(edges, edges[1:])]
    host += [(s, e) for name, s, e in tr.spans if name in SPANS]
    idle = [T.overlap_us(T.idle_gaps(tr, d), host) for d in tr.devices]
    return sum(idle) / len(idle) / tr.n_rounds / 1e3
