"""Bounded exponential backoff for transient backend I/O errors, a copy
of the JAX package's `repro/resilience/retry.py`."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to re-issue a failed backend call, and how long to
    wait between attempts.

    ``max_attempts`` counts the first try: 3 means one call plus up to
    two retries. Backoff is ``backoff_s * factor**(attempt-1)`` capped
    at ``backoff_max_s`` — deterministic (no jitter) so fault-injection
    tests can assert exact attempt counts.
    """

    max_attempts: int = 3
    backoff_s: float = 0.01
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.25

    def delay(self, attempt: int) -> float:
        """Seconds to sleep before retry number ``attempt`` (1-based)."""
        if attempt < 1:
            return 0.0
        d = self.backoff_s * (self.backoff_factor ** (attempt - 1))
        return min(d, self.backoff_max_s)

    def validate(self) -> None:
        assert self.max_attempts >= 1, "need at least one attempt"
        assert self.backoff_s >= 0.0 and self.backoff_max_s >= 0.0
        assert self.backoff_factor >= 1.0
