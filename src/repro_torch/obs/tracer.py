"""Lock-light per-thread ring-buffer event tracer (`repro_torch.obs`).

SSDTrain's headline claim — activation I/O fully overlapped with
compute — is only provable from the inside with a timeline: when did
each store/fetch/prefetch run, on which thread, and how long was the
consumer actually blocked. This tracer is the substrate:

  * one bounded ring buffer PER THREAD, appended only by its owning
    thread — the hot path takes no lock and allocates one tuple per
    event; a global lock guards only ring creation and snapshots;
  * span (begin/end, recorded as one complete event at exit) and
    instant events, timestamped with `time.perf_counter_ns` (monotonic,
    comparable across threads of one process);
  * bounded memory: a full ring overwrites its oldest events and counts
    every overwrite (`dropped` is exact: `max(0, total - capacity)`);
  * a thread-safe counter/gauge table (`add`/`set_gauge`/`counters`)
    for rates the timeline cannot express (prefetch hit/late/ghost,
    pool hits, queue backlogs).

The module-level helpers (`span`, `instant`, `count`) are the
always-compiled-in call sites the rest of the repo uses: when no tracer
is enabled they cost one global read and a None check, so tracing can
stay wired into the spool/backend/engine hot paths permanently.

Event layout (plain tuples, no classes, for append speed):

    (name, cat, ts_ns, dur_ns, args)    dur_ns >= 0  -> complete span
    (name, cat, ts_ns, -1,     args)    instant event
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: default ring capacity per thread (events); one event is ~100 bytes,
#: so the default bounds each thread at roughly 6 MB
DEFAULT_RING_SIZE = 1 << 16

TraceEvent = Tuple[str, str, int, int, dict]


class _Ring:
    """One thread's bounded event buffer. Appended only by the owning
    thread; snapshot from other threads is lock-free and sees a
    consistent prefix (CPython list-slot stores are atomic)."""

    __slots__ = ("events", "capacity", "total", "ring_id", "tid",
                 "thread_name", "open_depth")

    def __init__(self, capacity: int, ring_id: int, tid: int,
                 thread_name: str):
        # grown by append until capacity, then overwritten in place —
        # pre-allocating [None]*capacity would put a multi-ms list
        # allocation on the first event of every thread
        self.events: List[Optional[TraceEvent]] = []
        self.capacity = capacity
        self.total = 0              # events ever pushed (monotonic)
        self.ring_id = ring_id
        self.tid = tid
        self.thread_name = thread_name
        self.open_depth = 0         # spans entered but not yet exited

    def push(self, ev: TraceEvent) -> None:
        if self.total < self.capacity:
            self.events.append(ev)
        else:
            self.events[self.total % self.capacity] = ev
        self.total += 1

    @property
    def dropped(self) -> int:
        """Events overwritten because the ring was full — exact."""
        return max(0, self.total - self.capacity)

    def snapshot(self, start: int = 0) -> List[TraceEvent]:
        """Events [start, total) still resident, in record order.
        Entries already overwritten are silently absent (they are
        accounted in `dropped`)."""
        total = self.total
        lo = max(start, total - self.capacity, 0)
        return [self.events[i % self.capacity] for i in range(lo, total)]


class _Span:
    """Context manager recording one complete ("X") event at exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_ring")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._ring = self._tracer._ring()
        self._ring.open_depth += 1
        self._t0 = self._tracer._clock()
        return self

    def set(self, **args: Any) -> None:
        """Attach args discovered mid-span (e.g. bytes read)."""
        self._args.update(args)

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = self._tracer._clock()
        ring = self._ring
        ring.open_depth -= 1
        ring.push((self._name, self._cat, self._t0, t1 - self._t0,
                   self._args))


class _NullSpan:
    """Shared no-op span for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def set(self, **args: Any) -> None:
        pass

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide event sink; see module docstring. Usually driven
    through the module-level `enable()` / `span()` / `instant()` /
    `count()` helpers rather than instantiated directly (unit tests
    instantiate directly to keep state local)."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE,
                 clock: Optional[Any] = None):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.ring_size = ring_size
        # one clock everywhere; injectable so tests can drive virtual
        # time instead of asserting against wall-clock under load
        self._clock = clock or time.perf_counter_ns
        self.t0_ns = self._clock()              # export epoch
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    # -------------------------------------------------------- recording

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            with self._lock:
                ring = _Ring(self.ring_size, len(self._rings),
                             t.ident or 0, t.name)
                self._rings.append(ring)
            self._local.ring = ring
        return ring

    def span(self, name: str, cat: str = "", args: Optional[dict] = None
             ) -> _Span:
        return _Span(self, name, cat, args or {})

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        self._ring().push((name, cat, self._clock(), -1,
                           args or {}))

    def add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name] = value

    # -------------------------------------------------------- snapshots

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def rings(self) -> List[_Ring]:
        with self._lock:
            return list(self._rings)

    def open_spans(self) -> int:
        """Spans currently entered and not exited, across all threads —
        0 after a quiesced run means every begin had a matching end."""
        return sum(r.open_depth for r in self.rings())

    def dropped(self) -> int:
        """Total events overwritten across all rings."""
        return sum(r.dropped for r in self.rings())

    def total_events(self) -> int:
        """Total events ever recorded (resident + dropped)."""
        return sum(r.total for r in self.rings())

    def snapshot(self) -> List[TraceEvent]:
        """Every resident event, merged across threads, in start-time
        order."""
        out: List[TraceEvent] = []
        for ring in self.rings():
            out.extend(ring.snapshot())
        out.sort(key=lambda ev: ev[2])
        return out

    def snapshot_new(self, cursor: Optional[Dict[int, int]] = None
                     ) -> Tuple[List[TraceEvent], Dict[int, int]]:
        """Incremental snapshot: events recorded since `cursor` (a
        ring_id -> total map from the previous call), plus the new
        cursor. O(new events), so a per-step caller never rescans the
        whole run."""
        cursor = cursor or {}
        out: List[TraceEvent] = []
        new_cursor: Dict[int, int] = {}
        for ring in self.rings():
            out.extend(ring.snapshot(cursor.get(ring.ring_id, 0)))
            new_cursor[ring.ring_id] = ring.total
        out.sort(key=lambda ev: ev[2])
        return out, new_cursor


# ======================================================================
# Module-level tracer (the always-compiled-in call sites)
# ======================================================================

_TRACER: Optional[Tracer] = None


def enable(ring_size: int = DEFAULT_RING_SIZE) -> Tracer:
    """Install the process tracer (idempotent: an already-enabled
    tracer is kept, ring_size is ignored then)."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(ring_size)
    return _TRACER


def disable() -> None:
    """Drop the process tracer (its events die with it)."""
    global _TRACER
    _TRACER = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def is_enabled() -> bool:
    return _TRACER is not None


def span(name: str, cat: str = "", **args: Any):
    """`with obs.span("io.write", cat="io", key=k, bytes=n): ...` —
    a no-op singleton when tracing is disabled."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, args)


def instant(name: str, cat: str = "", **args: Any) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, args)


def count(name: str, n: float = 1) -> None:
    t = _TRACER
    if t is not None:
        t.add(name, n)


def gauge(name: str, value: float) -> None:
    t = _TRACER
    if t is not None:
        t.set_gauge(name, value)
