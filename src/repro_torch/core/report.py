"""Per-step report of the training engine, a copy of the JAX package's
`repro/core/report.py`: the same fields and the same metrics-JSONL
schema, so rows from either package compare key for key. The port's
staged engine fills the activation-footprint and spool fields and puts
device numbers (peak device bytes on the card) in `extra`. The `obs`
block (the overlap analysis of the step's trace window, emitted as
`obs_*` fields) is the JAX package's, key for key, and so are the
cache-manager block (`cache_*`) and the resilience block
(`resilience_*`), and so is the per-shard block of a mesh (`shards`:
the step's hook traffic by shard id, summed over the ranks).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class StepReport:
    loss: float
    step_time: float
    peak_activation_bytes: int = 0
    backward_begin_bytes: int = 0
    stats: Any = None                  # SpoolStats (or None: no spool)
    plan: Any = None                   # OffloadPlan (staged+adaptive only)
    step: int = -1                     # optimizer step index (-1: unset)
    engine: str = ""                   # "staged" | "jit"
    tokens_per_s: float = 0.0
    # engine-specific scalar metrics (the port: device_peak_bytes on the
    # card, offloaded / fetched stage counts); merged into the JSONL
    extra: Dict[str, float] = field(default_factory=dict)
    # repro_torch.obs overlap analysis for THIS step's trace window (see
    # repro_torch.obs.overlap.analyze); emitted with an obs_ prefix
    obs: Optional[Dict[str, Any]] = None
    # per-shard hook traffic deltas for this step, keyed by shard id
    # ("global" on a single device)
    shard_stats: Optional[Dict[str, Dict[str, int]]] = None
    # cache-manager block for this step (managed backend only): counter
    # deltas + residency gauges from CacheManager.metrics_delta; emitted
    # with a cache_ prefix
    cache: Optional[Dict[str, Any]] = None
    # resilience block for this step (any spool): retry / fallback /
    # re-plan / rebalance counter deltas plus backend-health gauges;
    # emitted with a resilience_ prefix
    resilience: Optional[Dict[str, Any]] = None

    def to_metrics(self) -> Dict[str, Any]:
        """Flat JSON-able dict — the unified metrics-JSONL schema.

        The spool fields are PER-STEP deltas: both engines snapshot
        `SpoolStats` at step boundaries and hand the report the
        difference, so a JSONL row describes its own step, not the run
        so far."""
        rec: Dict[str, Any] = {
            "step": self.step,
            "engine": self.engine,
            "loss": float(self.loss),
            "step_time_s": float(self.step_time),
            "tokens_per_s": float(self.tokens_per_s),
            "peak_activation_bytes": int(self.peak_activation_bytes),
            "backward_begin_bytes": int(self.backward_begin_bytes),
        }
        if self.stats is not None:
            rec["bytes_offloaded"] = int(self.stats.bytes_offloaded)
            rec["bytes_loaded"] = int(self.stats.bytes_loaded)
            rec["bytes_forwarded"] = int(self.stats.bytes_forwarded)
            rec["fetch_wait_s"] = float(self.stats.fetch_wait_time)
        if self.plan is not None:
            rec["plan_last_offloaded"] = int(self.plan.last_offloaded)
        if self.obs:
            for k, v in self.obs.items():
                rec[f"obs_{k}"] = v
        if self.shard_stats:
            rec["shards"] = self.shard_stats
        if self.cache:
            for k, v in self.cache.items():
                rec[f"cache_{k}"] = v
        if self.resilience is not None:
            for k, v in self.resilience.items():
                rec[f"resilience_{k}"] = v
        for k, v in self.extra.items():
            rec.setdefault(k, v)
        return rec
