"""Per-backend health monitor: consecutive failures + latency drift, a
copy of the JAX package's `repro/resilience/health.py`.

The spool's retry wrapper feeds every backend call outcome into a
`BackendHealth` instance. The monitor keeps per-op (write/read)
counters and a latency EWMA, derives a three-state status, and pushes
`HealthEvent`s to subscribers on every state *transition*:

  healthy  — normal operation
  degraded — op latency EWMA exceeds ``degrade_latency_ratio`` times
             the baseline established over the first ``min_samples``
             successful calls (a slowly dying SSD looks exactly like
             this: no errors yet, bandwidth collapsing)
  failing  — ``fail_threshold`` consecutive failures on an op (the
             device is effectively gone)

AdaptivePolicy subscribes and re-plans on "degraded"/"failing"; obs
gauges mirror the state so the per-step metrics show the transition.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch import obs

HEALTHY, DEGRADED, FAILING = "healthy", "degraded", "failing"
_STATUS_CODE = {HEALTHY: 0, DEGRADED: 1, FAILING: 2}


@dataclass(frozen=True)
class HealthEvent:
    """One state transition of a monitored backend."""

    kind: str                  # "degraded" | "failing" | "recovered"
    backend: str               # backend kind string, e.g. "striped"
    op: str                    # "write" | "read"
    consecutive_failures: int
    latency_ratio: float       # current EWMA / baseline (1.0 = nominal)
    error: Optional[str] = None


@dataclass
class _OpState:
    consec_failures: int = 0
    failures: int = 0
    successes: int = 0
    baseline_s: Optional[float] = None   # mean of first min_samples
    baseline_n: int = 0
    baseline_sum: float = 0.0
    ewma_s: Optional[float] = None
    status: str = HEALTHY


class BackendHealth:
    """Thread-safe health tracker for one storage backend."""

    def __init__(self, backend: str = "?", *, fail_threshold: int = 3,
                 degrade_latency_ratio: float = 4.0,
                 ema_alpha: float = 0.25, min_samples: int = 8) -> None:
        assert fail_threshold >= 1
        assert degrade_latency_ratio > 1.0
        self.backend = backend
        self.fail_threshold = fail_threshold
        self.degrade_latency_ratio = degrade_latency_ratio
        self.ema_alpha = ema_alpha
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._ops: Dict[str, _OpState] = {}
        self._subs: List[Callable[[HealthEvent], None]] = []
        self.events: List[HealthEvent] = []

    # ------------------------------------------------------ subscribe
    def subscribe(self, cb: Callable[[HealthEvent], None]) -> None:
        """Register ``cb`` to be called (outside the monitor lock, on
        the recording thread) for every state transition."""
        with self._lock:
            self._subs.append(cb)

    # ------------------------------------------------------ recording
    def record_success(self, op: str, seconds: float) -> None:
        ev = None
        with self._lock:
            st = self._ops.setdefault(op, _OpState())
            st.successes += 1
            st.consec_failures = 0
            if st.baseline_s is None:
                st.baseline_n += 1
                st.baseline_sum += seconds
                if st.baseline_n >= self.min_samples:
                    st.baseline_s = max(st.baseline_sum / st.baseline_n,
                                        1e-9)
            a = self.ema_alpha
            st.ewma_s = (seconds if st.ewma_s is None
                         else (1 - a) * st.ewma_s + a * seconds)
            ratio = self._ratio(st)
            if st.status == FAILING:
                st.status = (DEGRADED if self._is_degraded(st)
                             else HEALTHY)
                ev = self._event("recovered", op, st, ratio)
            elif st.status == HEALTHY and self._is_degraded(st):
                st.status = DEGRADED
                ev = self._event("degraded", op, st, ratio)
            elif st.status == DEGRADED and not self._is_degraded(st):
                st.status = HEALTHY
                ev = self._event("recovered", op, st, ratio)
        self._emit(ev)

    def record_failure(self, op: str, exc: BaseException,
                       seconds: float = 0.0) -> None:
        ev = None
        with self._lock:
            st = self._ops.setdefault(op, _OpState())
            st.failures += 1
            st.consec_failures += 1
            if (st.consec_failures >= self.fail_threshold
                    and st.status != FAILING):
                st.status = FAILING
                ev = self._event(FAILING, op, st, self._ratio(st),
                                 error=repr(exc))
        self._emit(ev)

    # ------------------------------------------------------ inspection
    @property
    def status(self) -> str:
        """Worst status across ops."""
        with self._lock:
            worst = HEALTHY
            for st in self._ops.values():
                if _STATUS_CODE[st.status] > _STATUS_CODE[worst]:
                    worst = st.status
            return worst

    def latency_ratio(self, op: str = "write") -> float:
        with self._lock:
            st = self._ops.get(op)
            return self._ratio(st) if st else 1.0

    def snapshot(self) -> Dict[str, object]:
        """Flat dict for metrics emission (resilience_ block)."""
        with self._lock:
            out: Dict[str, object] = {
                "health": _STATUS_CODE[self._worst_locked()],
                "health_events": len(self.events),
            }
            for op, st in self._ops.items():
                out[f"{op}_failures"] = st.failures
                out[f"{op}_consec_failures"] = st.consec_failures
                out[f"{op}_latency_ratio"] = round(self._ratio(st), 3)
            return out

    # ------------------------------------------------------ internals
    def _worst_locked(self) -> str:
        worst = HEALTHY
        for st in self._ops.values():
            if _STATUS_CODE[st.status] > _STATUS_CODE[worst]:
                worst = st.status
        return worst

    def _ratio(self, st: _OpState) -> float:
        if st.baseline_s is None or st.ewma_s is None:
            return 1.0
        return st.ewma_s / st.baseline_s

    def _is_degraded(self, st: _OpState) -> bool:
        return self._ratio(st) > self.degrade_latency_ratio

    def _event(self, kind: str, op: str, st: _OpState, ratio: float,
               error: Optional[str] = None) -> HealthEvent:
        ev = HealthEvent(kind=kind, backend=self.backend, op=op,
                         consecutive_failures=st.consec_failures,
                         latency_ratio=ratio, error=error)
        self.events.append(ev)
        return ev

    def _emit(self, ev: Optional[HealthEvent]) -> None:
        if ev is None:
            return
        if obs.is_enabled():
            obs.instant(f"resilience.{ev.kind}", cat="resilience",
                        backend=ev.backend, op=ev.op,
                        consec=ev.consecutive_failures,
                        latency_ratio=round(ev.latency_ratio, 3),
                        error=ev.error or "")
            # the gauge takes a name and a value: the JAX package passes
            # backend= too, which raises TypeError inside the I/O worker
            # whenever a transition happens under tracing
            obs.gauge("resilience.health", _STATUS_CODE[self.status])
        with self._lock:
            subs = list(self._subs)
        for cb in subs:
            try:
                cb(ev)
            except Exception:
                pass  # a broken subscriber must not kill an I/O worker
