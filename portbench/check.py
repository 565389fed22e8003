"""The comparison that decides ``correct``: the program's first three
rounds against the plain reference's, from the same weights and batches.

Readings of one side (``Readings``): each round's per-client private CE,
public CE and Eq.-2 KL as the round reports them; the norm of each
client's first gradient as the optimizer got it, by leaf; and the norm of
each client's parameter change over the three rounds, by leaf.  The
numbers compared (each against the reference):

  - ``ce_gap``: the largest relative gap of a CE (private or public, any
    round, any client);
  - ``kl_gap``: the largest relative gap of an Eq.-2 term;
  - ``grad_gap``: the worst leaf's gap between the two first-gradient
    norms, over the reference's norm of that leaf or of the median leaf,
    whichever is larger;
  - ``grad_gap_median``: the same gap of each client's median leaf, the
    worst client's: steady where a deep bf16 model's worst leaf swings
    from seed to seed, and moved by a fault that most leaves' gradients
    share (a wrong backward of a layer every block runs);
  - ``update_gap``: the same for the parameter change, over the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's (a leaf with none moves by rounding alone).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from portbench import reference
from portbench.weights import make_weights
from portbench.yard import tokens as toks

CHECKED_ROUNDS = 3         # a cell's "checked_rounds" may take fewer
NUMBERS = ("ce_gap", "kl_gap", "grad_gap", "grad_gap_median", "update_gap")
KEEP = 1e-3                # a leaf's gradient under this x the median's


@dataclass
class Readings:
    losses: List[Dict[str, List[float]]] = field(default_factory=list)
    grad_norms: List[Dict[tuple, float]] = field(default_factory=list)
    change_norms: List[Dict[tuple, float]] = field(default_factory=list)


def checked_rounds(cell: dict) -> int:
    """The rounds the reference follows: three, or two where three would
    take it longer than the window."""
    return cell.get("checked_rounds", CHECKED_ROUNDS)


def batches(cell: dict, seed: int, r: int):
    """(private (K, B, S), public (B_pub, S)) tokens of round ``r``."""
    tr, V = cell["traffic"], cell["config"]["model"]["vocab_size"]
    args = (r, seed, tr["clients"], tr["batch"], tr["seq"], V)
    return toks.private_batch(*args), toks.public_batch(*args)


def reference_readings(cell: dict, seed: int, devices,
                       precision: str = "fp32", fault=None) -> Readings:
    """The reference's readings over the checked rounds, from the weights
    ``weights.make_weights`` makes from ``seed`` on ``devices[0]``, as it
    made the program's."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell["traffic"]
    fleet = reference.RefFleet(
        make_weights(cell["config"]["model"], tr["clients"], seed,
                     devices[0]), cell["config"]["model"], tr, devices,
        precision)
    start = [{k: t.clone() for k, _, _, t in reference._param_paths(
        p, fleet.cfg)} for p in fleet.params]
    out = Readings()
    for r in range(checked_rounds(cell)):
        res = fleet.round(*batches(cell, seed, r), fault=fault)
        out.losses.append({k: res[k] for k in
                           ("private_ce", "public_ce", "kl")})
        if r == 0:
            out.grad_norms = res["grad_norms"]
    for c, p in enumerate(fleet.params):
        delta = {key: t - start[c][key] for key, _, _, t in
                 reference._param_paths(p, fleet.cfg)}
        out.change_norms.append(fleet._norms(delta, c))
    del fleet, start
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gaps(prog: List[Dict], ref: List[Dict], keep=None):
    """Each client's list of |prog - ref| / max(ref, median ref) by leaf."""
    med = statistics.median(v for c in ref for v in c.values())
    out = []
    for c, (pc, rc) in enumerate(zip(prog, ref)):
        if set(pc) != set(rc):
            raise ValueError(f"client {c}: leaves differ: "
                             f"{sorted(set(pc) ^ set(rc))}")
        out.append([abs(pc[path] - rv) / max(rv, med, 1e-30)
                    for path, rv in rc.items()
                    if keep is None or keep[c][path]])
    return out


def _worst_leaf(prog: List[Dict], ref: List[Dict], keep=None) -> float:
    """max over (client, leaf) of |prog - ref| / max(ref, median ref)."""
    return max(max(g, default=0.0) for g in _leaf_gaps(prog, ref, keep))


def _median_leaf(prog: List[Dict], ref: List[Dict]) -> float:
    """max over clients of the median leaf's gap."""
    return max(statistics.median(g) for g in _leaf_gaps(prog, ref))


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared (module docstring)."""
    ce, kl = 0.0, 0.0
    for pr, rr in zip(prog.losses, ref.losses):
        for k in ("private_ce", "public_ce"):
            ce = max([ce] + [_rel(a, b) for a, b in zip(pr[k], rr[k])])
        kl = max([kl] + [_rel(a, b) for a, b in zip(pr["kl"], rr["kl"])])
    med = statistics.median(v for c in ref.grad_norms for v in c.values())
    keep = [{p: v >= KEEP * med for p, v in c.items()}
            for c in ref.grad_norms]
    return {"ce_gap": ce, "kl_gap": kl,
            "grad_gap": _worst_leaf(prog.grad_norms, ref.grad_norms),
            "grad_gap_median": _median_leaf(prog.grad_norms,
                                            ref.grad_norms),
            "update_gap": _worst_leaf(prog.change_norms, ref.change_norms,
                                      keep)}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell compares (those ``limits`` names) within its
    limit (a NaN is outside)."""
    return all(bool(np.isfinite(nums[k])) and nums[k] <= v
               for k, v in limits.items())
