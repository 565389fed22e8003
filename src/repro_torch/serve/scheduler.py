"""Continuous batching: a request queue + slot-based bookkeeping (the
port's own copy of ``repro/serve/scheduler.py``; numpy only).

The scheduler is pure host-side state — it never touches device arrays.
The engine asks it which slot to admit the next queued request into and
tells it which tokens each slot emitted; the scheduler tracks per-slot
request identity, emitted counts and budgets, and retires requests the
moment their budget is spent.  Slot lifecycle:

    FREE --admit(prefill + slot write)--> ACTIVE --budget spent--> FREE

Admission and retirement happen MID-FLIGHT: the engine decodes the whole
arena in fixed-shape chunks, and between chunks the scheduler frees
finished slots and refills them from the queue, so one decode program
serves heterogeneous in-flight requests (different prompt lengths,
depths, and budgets).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    """One generation request.  ``tokens`` is the raw prompt (S0,) int32;
    ``prefix`` the optional (P, prefix_dim) frontend embedding for
    prefix-token archs; ``max_new`` the generation budget."""
    rid: int
    tokens: np.ndarray
    max_new: int
    prefix: Optional[np.ndarray] = None


@dataclass
class _Slot:
    req: Request
    emitted: List[int] = field(default_factory=list)


class SlotScheduler:
    """FIFO admission over a fixed number of slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.done: Dict[int, np.ndarray] = {}
        self._next_rid = 0

    # -- submission -------------------------------------------------------
    def submit(self, tokens, max_new: int, prefix=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(tokens, np.int32),
                                  int(max_new),
                                  None if prefix is None
                                  else np.asarray(prefix, np.float32)))
        return rid

    # -- state queries ----------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def free_slots(self) -> List[int]:
        return [b for b, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> List[int]:
        return [b for b, s in enumerate(self.slots) if s is not None]

    def next_request(self) -> Optional[Request]:
        return self.queue[0] if self.queue else None

    # -- lifecycle --------------------------------------------------------
    def admit(self, slot: int) -> Request:
        """Bind the head-of-queue request to a free slot."""
        assert self.slots[slot] is None, f"slot {slot} is occupied"
        req = self.queue.popleft()
        self.slots[slot] = _Slot(req)
        return req

    def record(self, slot: int, tokens: np.ndarray) -> bool:
        """Credit a chunk of emitted tokens to a slot; tokens past the
        request's budget (a retirement mid-chunk) are dropped.  Returns
        True when the request finished and the slot is now free."""
        st = self.slots[slot]
        assert st is not None, f"slot {slot} is free"
        take = min(len(tokens), st.req.max_new - len(st.emitted))
        st.emitted.extend(int(t) for t in tokens[:take])
        if len(st.emitted) >= st.req.max_new:
            self.done[st.req.rid] = np.asarray(st.emitted, np.int32)
            self.slots[slot] = None
            return True
        return False
