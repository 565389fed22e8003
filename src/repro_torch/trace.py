"""Spans and counters of the port's own layers.

``span(name)`` opens a host range while a profiler records, so the range
lands in the profiler's trace on the clock of the kernels it launches;
with no profiler it returns a shared no-op context and costs one check.
The spans are named ``repro.<layer>.<what>`` and nest: a span's parent is
the span that caused it.  A span is an operator-scope range (the
profiler's ``cpu_op``), not a ``record_function`` user annotation: the
profiler mirrors a user annotation onto the device timeline as one more
device event, and a reader of the device timeline would count the mirror
as work.  The kernels launched inside a span link to it through their
launch calls' correlation ids, which lie inside the span on the host.

``counts`` holds the program's counters, always on: ``host_sync`` counts
each place the host waits for the card (a device-to-host read through
``to_host``, a synchronous host-to-device copy of a batch), ``round`` each
round a ``Federation`` runs.  A reader takes the increments over the
stretch it watches.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch._C._profiler import _RecordFunctionFast

counts: Dict[str, int] = {}
_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A host range named ``name`` while a profiler records; a no-op
    context otherwise."""
    if _recording():
        return _RecordFunctionFast(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    counts[name] = counts.get(name, 0) + n


def to_host(t: torch.Tensor):
    """``t.tolist()``, inside a ``repro.sync`` span, counted as a
    ``host_sync``: the host waits there for the card's queue."""
    with span("repro.sync"):
        count("host_sync")
        return t.tolist()
