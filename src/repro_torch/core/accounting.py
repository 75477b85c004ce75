"""Exact activation-memory accounting (paper Fig. 7 timelines), copied
from the JAX package's `repro/core/accounting.py`.

The metric the paper plots is the *activation* footprint, which is fully
determined by which saved-residual tensors are live (on the card the
device's own peak, `torch.cuda.max_memory_allocated`, is reported
beside it). The tracker records
every alloc/free with a timestamp, yielding the footprint timeline, its
peak, and the begin-of-backward footprint the paper highlights (45% / 25%
reductions in Fig. 7).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class MemoryEvent:
    t: float
    total: int
    tag: str


class MemoryTracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[Tuple, int] = {}
        self._total = 0
        self._peak = 0
        self.events: List[MemoryEvent] = []
        self._t0 = time.perf_counter()
        self.marks: Dict[str, float] = {}

    def _record(self, tag):
        self.events.append(MemoryEvent(time.perf_counter() - self._t0,
                                       self._total, tag))
        self._peak = max(self._peak, self._total)

    def alloc(self, key, nbytes: int, tag: str = "") -> None:
        with self._lock:
            if key in self._live:
                return
            self._live[key] = nbytes
            self._total += nbytes
            self._record(tag or f"alloc:{key}")

    def free(self, key, tag: str = "") -> None:
        with self._lock:
            nbytes = self._live.pop(key, None)
            if nbytes is None:
                return
            self._total -= nbytes
            self._record(tag or f"free:{key}")

    def mark(self, name: str) -> None:
        """Named timeline marker (e.g. 'backward_begin')."""
        with self._lock:
            self.marks[name] = time.perf_counter() - self._t0

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    @property
    def current(self) -> int:
        with self._lock:
            return self._total

    def footprint_at(self, t: float) -> int:
        """Footprint at timeline time t (step function evaluation)."""
        with self._lock:
            total = 0
            for ev in self.events:
                if ev.t > t:
                    break
                total = ev.total
            return total

    def timeline(self) -> List[Tuple[float, int]]:
        with self._lock:
            return [(e.t, e.total) for e in self.events]

    def reset_peak(self) -> None:
        with self._lock:
            self._peak = self._total
