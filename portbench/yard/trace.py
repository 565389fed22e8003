"""Reduction of a ``torch.profiler`` trace to intervals.

``device_union`` is a frozen copy of the union in ``chip_smoke.py::
device_spans`` (activities that overlap count once).  ``Trace`` holds the
device activities (kernels, copies, sets) with their card, and the host
spans the benchmark opened with ``record_function``, all in the
profiler's microseconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

COPY_PREFIXES = ("Memcpy", "Memset")
SPAN_PREFIX = "bench."            # the benchmark's own host ranges


@dataclass(frozen=True)
class Activity:
    name: str
    device: int
    start: float          # us
    end: float

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(COPY_PREFIXES)


@dataclass
class Trace:
    activities: List[Activity]
    spans: List[Tuple[str, float, float]]      # (name, start, end) on host
    rounds: List[Tuple[float, float]]          # the profiled rounds' spans
    devices: Sequence[int]

    @property
    def start(self) -> float:
        return self.rounds[0][0]

    @property
    def end(self) -> float:
        return self.rounds[-1][1]

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def in_rounds(self) -> List[Activity]:
        """Activities that start inside a profiled round."""
        return [a for a in self.activities
                if any(s <= a.start <= e for s, e in self.rounds)]


def device_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    union, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            union += b - max(a, end)
            end = b
    return union


def overlap_us(a, b) -> float:
    """Length of the part of the union of intervals ``a`` that the union
    of intervals ``b`` covers."""
    a, b = list(a), list(b)
    return device_union(a) + device_union(b) - device_union(a + b)


def busy_us(trace: Trace, device: int) -> float:
    """Microseconds of the profiled rounds' stretch in which at least one
    activity ran on ``device``."""
    lo, hi = trace.start, trace.end
    return device_union([(max(a.start, lo), min(a.end, hi))
                         for a in trace.activities
                         if a.device == device and a.end > lo
                         and a.start < hi])


def idle_gaps(trace: Trace, device: int) -> List[Tuple[float, float]]:
    """The intervals of the profiled stretch with nothing on ``device``."""
    lo, hi = trace.start, trace.end
    gaps, cur = [], lo
    for a, b in sorted((x.start, x.end) for x in trace.activities
                       if x.device == device and x.end > lo
                       and x.start < hi):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def span_at(trace: Trace, t: float) -> str:
    """The innermost benchmark span open on the host at ``t``."""
    best, length = "outside any span", float("inf")
    for name, s, e in trace.spans:
        if s <= t <= e and e - s < length:
            best, length = name, e - s
    return best


def base_name(kernel: str) -> str:
    """A demangled kernel's function name without its return type,
    namespaces, template arguments or parameters:
    ``void (anonymous namespace)::tc::attn_fwd_tc<128>(Args)`` ->
    ``attn_fwd_tc``."""
    s = kernel.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    cut = [i for i in (s.find("<"), s.find("(")) if i >= 0]
    if cut:
        s = s[:min(cut)]
    return s.rsplit("::", 1)[-1].strip()


def device_seconds(trace: Trace, names: Sequence[str]) -> float:
    """Device seconds of the activities in the profiled rounds whose
    function name (``base_name``) is one of ``names``."""
    want = set(names)
    return sum(a.end - a.start for a in trace.in_rounds()
               if base_name(a.name) in want) / 1e6


def by_name(trace: Trace) -> Dict[str, float]:
    """Device seconds of each activity name in the profiled rounds."""
    acc: Dict[str, float] = {}
    for a in trace.in_rounds():
        acc[a.name] = acc.get(a.name, 0.0) + (a.end - a.start) / 1e6
    return acc


def from_profiler(prof, devices: Sequence[int], round_name: str) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``: its CUDA
    activities, and its host ranges; the ranges named ``round_name`` are
    the profiled rounds."""
    from torch.autograd import DeviceType
    acts, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX):
            # the host range; its mirror on the device timeline is no work
            if e.device_type == DeviceType.CPU:
                spans.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            acts.append(Activity(e.name, int(e.device_index), tr.start,
                                 tr.end))
    rounds = sorted((s, e) for n, s, e in spans if n == round_name)
    return Trace(acts, spans, rounds, list(devices))
