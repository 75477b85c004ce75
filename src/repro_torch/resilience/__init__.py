"""repro_torch.resilience — ride through a dying SSD, a copy of the JAX
package's `repro/resilience`.

  RetryPolicy    — bounded exponential backoff for transient I/O errors
                   (classified by repro_torch.io.backend.classify_io_error);
                   the spool's store/load workers wrap every backend
                   call in it.
  BackendHealth  — per-backend health monitor: consecutive-failure and
                   latency-degradation tracking, with state-transition
                   events ("degraded" / "failing" / "recovered") pushed
                   to subscribers. AdaptivePolicy subscribes and
                   re-plans mid-run when the backend sours.
  ChaosHarness   — test/ops tool that scripts faults against a live
                   backend stack (kill a stripe device, flaky writes,
                   raising reads, ENOSPC) and aggregates the injected
                   counters the chaos tests assert on.

The degradation ladder, end to end: healthy offload → retry/backoff →
stripe rebalancing away from the sick device → tier fallback (managed
backend) → recompute of the stage when a residual is truly lost.
"""
from repro_torch.resilience.chaos import ChaosHarness, unwrap_chain
from repro_torch.resilience.health import BackendHealth, HealthEvent
from repro_torch.resilience.retry import RetryPolicy

__all__ = [
    "BackendHealth",
    "ChaosHarness",
    "HealthEvent",
    "RetryPolicy",
    "unwrap_chain",
]
