"""The profiled rounds of one cell, by the program's own spans.

    python3 portbench/spans.py --workload <name> --seed <n> [--rounds 4]

Sets the cell up as a run of ``run.py`` does, profiles ``--rounds`` rounds
under ``torch.profiler`` and prints a table by the program's spans
(``repro_torch.trace.span``: ``repro.<layer>.<what>``, outermost first)
open at the time: kernels, device ms and idle ms a round, mean over the
cards.  A device activity counts under the spans open at its launch call
(the host event of the CUDA runtime that shares its correlation id), an
idle gap under those open at its middle.  Below the table: the share of
the kernels' time launched below ``repro.round``, the device time a round
launched inside ``repro.optim.adamw``, the device idle a round inside
``repro.step.forward`` and ``repro.step.backward``, the host syncs a round
and the profiled rounds' median.  No metric of a run reads this script.
"""
from __future__ import annotations

import argparse
import bisect
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402
from portbench.metrics import host_syncs_per_round  # noqa: E402
from portbench.yard import trace as T  # noqa: E402

PROGRAM_PREFIX = "repro."         # the program's own host ranges
ROUND = PROGRAM_PREFIX + "round"
# host events of the CUDA runtime and its lower API (``cudaLaunchKernel``,
# ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)
RUNTIME_PREFIX = "cu"
ADAMW = (PROGRAM_PREFIX + "optim.adamw",)
STEP = (PROGRAM_PREFIX + "step.forward", PROGRAM_PREFIX + "step.backward")


@dataclass
class Profiled:
    trace: T.Trace                 # as a traced run of the cell reduces it
    launches: List[Optional[float]]   # host time of each activity's launch
    program: List[Tuple[str, float, float]]   # the program's host ranges
    mirrors: int                   # device events named as a program range


def parse(prof, devices: Sequence[int]) -> Profiled:
    """The trace of a finished profile as ``yard/trace.py`` reduces it,
    with the launch time of each of its activities where the profile
    links one, and the program's host ranges."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    tr = T.from_profiler(prof, devices, harness.ROUND_SPAN)
    at = {e.id: e.time_range.start for e in events
          if e.device_type == DeviceType.CPU
          and e.name.startswith(RUNTIME_PREFIX)}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(T.SPAN_PREFIX)]
    assert len(device) == len(tr.activities)
    return Profiled(tr, [at.get(e.id) for e in device],
                    [(e.name, e.time_range.start, e.time_range.end)
                     for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith(PROGRAM_PREFIX)],
                    sum(e.name.startswith(PROGRAM_PREFIX) for e in device))


def span_paths(program) -> Callable[[float], Tuple[str, ...]]:
    """A function of a host time: the names of the program's ranges open
    then, outermost first, () where none is."""
    edges = sorted({t for _, s, e in program for t in (s, e)})
    opened: Dict[float, list] = {}
    closed: Dict[float, list] = {}
    for i, (n, s, e) in enumerate(program):
        opened.setdefault(s, []).append((s, -e, i, n))
        closed.setdefault(e, []).append((s, -e, i, n))
    paths, live = [], set()
    for t in edges:                   # the path of [t, next edge)
        live.difference_update(closed.get(t, ()))
        live.update(x for x in opened.get(t, ()) if x[0] < -x[1])
        paths.append(tuple(x[3] for x in sorted(live)))

    def at(t: float) -> Tuple[str, ...]:
        i = bisect.bisect_right(edges, t) - 1
        return paths[i] if i >= 0 else ()
    return at


def _in_rounds(p: Profiled):
    """(activity, launch) of the activities that start inside a profiled
    round."""
    return [(a, t) for a, t in zip(p.trace.activities, p.launches)
            if any(s <= a.start <= e for s, e in p.trace.rounds)]


def launched_in(p: Profiled, names: Sequence[str]) -> List[T.Activity]:
    """The profiled rounds' activities launched while a program range
    named one of ``names`` was open (at any depth below it)."""
    want = set(names)
    at = span_paths([x for x in p.program if x[0] in want])
    return [a for a, t in _in_rounds(p) if t is not None and at(t)]


def adamw_ms(p: Profiled) -> Optional[float]:
    """Device ms a round of the work launched inside AdamW, mean over the
    cards."""
    acts = launched_in(p, ADAMW)
    if not acts:
        return None
    us = sum(a.end - a.start for a in acts)
    return us / len(p.trace.devices) / p.trace.n_rounds / 1e3


def launch_idle_ms(p: Profiled) -> Optional[float]:
    """Device idle ms a round inside the step's forward and backward
    ranges, where the card waits on the host's launches, mean over the
    cards."""
    tr = p.trace
    spans = [(s, e) for n, s, e in p.program if n in STEP]
    if not spans:
        return None
    idle = [T.overlap_us(T.idle_gaps(tr, d), spans) for d in tr.devices]
    return sum(idle) / len(idle) / tr.n_rounds / 1e3


def table(p: Profiled) -> dict:
    """``rows``: [spans, kernels, device ms, idle ms] a round, mean over
    the cards, the most time first; ``covered``: the share of the kernels'
    time launched inside a program range below ``repro.round``;
    ``linked``: the share of activities whose launch the profile links."""
    tr, at = p.trace, span_paths(p.program)
    rows: Dict[str, List[float]] = {}

    def row(t):
        path = at(t) if t is not None else ("launch not linked",)
        key = " > ".join(n.removeprefix(PROGRAM_PREFIX) for n in path)
        return rows.setdefault(key or "outside any span", [0, 0.0, 0.0])
    acts = _in_rounds(p)
    k_all = k_in = 0.0
    for a, t in acts:
        r = row(t)
        r[0] += a.is_kernel
        r[1] += a.end - a.start
        if a.is_kernel:
            k_all += a.end - a.start
            if t is not None and any(n != ROUND for n in at(t)):
                k_in += a.end - a.start
    for d in tr.devices:
        for a, b in T.idle_gaps(tr, d):
            row((a + b) / 2)[2] += b - a
    per = len(tr.devices) * tr.n_rounds
    return {"rows": sorted(([k, n / per, dev / per / 1e3, idle / per / 1e3]
                            for k, (n, dev, idle) in rows.items()),
                           key=lambda r: -(r[2] + r[3])),
            "covered": k_in / k_all if k_all else 0.0,
            "linked": (sum(t is not None for _, t in acts) / len(acts)
                       if acts else 0.0)}


def profile_rounds(prog, n: int, devices: Sequence[int]):
    """(the profile of ``n`` rounds as ``Profiled``, the program's host
    syncs a round over them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    kinds = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    before = host_syncs_per_round.program_counts().get("host_sync", 0)
    with profile(activities=kinds) as prof:
        for _ in range(n):
            with record_function(harness.ROUND_SPAN):
                prog.round()
    after = host_syncs_per_round.program_counts().get("host_sync", 0)
    return parse(prof, devices), (after - before) / n


def report(p: Profiled, syncs: float, log=sys.stdout) -> None:
    t = table(p)
    print("by program span, a round (mean over cards): kernels, device ms, "
          "idle ms", file=log)
    for name, n, dev, idle in t["rows"]:
        print(f"  {name:<48} {n:10.1f} {dev:10.3f} {idle:10.3f}", file=log)
    rounds = [(e - s) / 1e3 for s, e in p.trace.rounds]
    print(f"kernel time launched below repro.round "
          f"{100 * t['covered']:.2f}%, launch linked for "
          f"{100 * t['linked']:.2f}% of activities, device events named as "
          f"a program span {p.mirrors}", file=log)
    print(f"adamw_ms {adamw_ms(p)!r} launch_idle_ms {launch_idle_ms(p)!r} "
          f"host_syncs {syncs!r} round_ms median "
          f"{statistics.median(rounds)!r} of {rounds!r}", file=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=harness.PROFILED_ROUNDS)
    args = ap.parse_args(argv)

    import torch
    cell = harness.load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"spans: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    harness.load_kernels(cell["config"]["model"])
    prog, _ = harness.set_up(cell, args.seed % 2 ** 63, devices, "cuda")
    report(*profile_rounds(prog, args.rounds, list(range(chips))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
