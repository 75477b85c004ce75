"""Offload policies of the staged engine, copied from the JAX package's
`repro/core/policies.py` (`OffloadPolicy` and its four ROK axes, §4.3).

The engine asks a policy two questions and never interprets strings:

    should_offload(stage, profile)   -> spool this stage's residuals?
    on_profile(profiles, bandwidth)  -> digest the profiling step
                                        (AdaptivePolicy: compute the plan)

Policies:
  KeepPolicy       residuals stay on device (the ROK "K" axis)
  SpoolPolicy      offload every eligible stage unconditionally ("O")
  RecomputePolicy  layerwise recomputation; only module inputs kept ("R")
  AdaptivePolicy   paper §3.3.3: profile step 0, then offload only the
                   prefix the measured store bandwidth can hide

AdaptivePolicy re-plans mid-run on the spool's backend health events
(`attach_health`) and feeds its profiled step time to a cache manager as
per-class reuse distances (`attach_cache_manager`). Not ported yet (they
wait for the optimizer overlap and the jit engine): `price_opt_io` and
the jit-engine plan; `opt_bytes_per_step` prices optimizer traffic that
shares the write path when a caller gives it.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.core.adaptive import (BWD_FACTOR, BandwidthLike,
                                       ModuleProfile, OffloadPlan,
                                       TierBandwidth, plan_offload)

#: stage roles whose backward can be recomputed from the module input
RECOMPUTABLE_ROLES = ("layer", "enc_layer")


def _scale_bandwidths(bw: BandwidthLike, scale: float) -> BandwidthLike:
    """Bandwidths as the planner should see them after a health event:
    every tier's write rate scaled by `scale` (0.0 = device gone)."""
    if isinstance(bw, (int, float)):
        return float(bw) * scale
    return [TierBandwidth(t.name, t.write_bw * scale, t.capacity_bytes)
            for t in bw]


class OffloadPolicy:
    """Base policy: decides, per stage, where residuals live."""

    strategy = "offload"

    #: the engine runs a profiling step (sync-timed stages, wait_io,
    #: calibrate) while this is True
    wants_profile = False

    plan: Optional[OffloadPlan] = None

    def recomputes(self, role: str) -> bool:
        """True if this stage's backward should re-run forward instead of
        saving residuals."""
        return False

    def should_offload(self, stage: int,
                       profile: Optional[ModuleProfile] = None) -> bool:
        raise NotImplementedError

    def on_profile(self, profiles: Sequence[ModuleProfile],
                   bandwidths: BandwidthLike) -> Optional[OffloadPlan]:
        """Digest the profiling step. Returns the plan (or None when the
        policy is static)."""
        return None

    def __repr__(self):
        return f"{type(self).__name__}()"


class KeepPolicy(OffloadPolicy):
    """All residuals stay in device memory (tracked for the footprint
    curve, never written)."""

    strategy = "keep"

    def should_offload(self, stage, profile=None) -> bool:
        return False


class SpoolPolicy(OffloadPolicy):
    """Unconditional TBA: every eligible stage's residuals go to the
    spool."""

    strategy = "offload"

    def should_offload(self, stage, profile=None) -> bool:
        return True


class RecomputePolicy(OffloadPolicy):
    """Layerwise full recomputation: layer stages keep only their input
    and re-run forward during backward; other stages keep residuals on
    device."""

    strategy = "recompute"

    def recomputes(self, role: str) -> bool:
        return role in RECOMPUTABLE_ROLES

    def should_offload(self, stage, profile=None) -> bool:
        return False


class AdaptivePolicy(OffloadPolicy):
    """Paper §3.3.3: offload everything during the profiling step, then
    plan the largest offloaded prefix whose transfer deadline the
    measured (per-tier) store bandwidth can hold."""

    strategy = "offload"

    def __init__(self, *, bwd_factor: float = BWD_FACTOR,
                 always_keep_last: bool = True,
                 opt_bytes_per_step: int = 0):
        self.bwd_factor = bwd_factor
        self.always_keep_last = always_keep_last
        # optimizer-state bytes written per step through the same path
        # (priced out of the activation deadline test); 0: none
        self.opt_bytes_per_step = int(opt_bytes_per_step)
        self.plan = None
        self.profiles: Optional[List[ModuleProfile]] = None
        self.bandwidths: Optional[BandwidthLike] = None
        self.cache_manager = None
        # mid-run re-plans triggered by backend health events
        self.replans = 0
        self.last_health_event = None
        self._replan_lock = threading.Lock()

    def attach_cache_manager(self, manager) -> None:
        """Connect a `repro_torch.cache.CacheManager` backend: after the
        profiling step the policy turns its measured step time into the
        manager's per-class reuse distances, so tier placement and the
        offload plan derive from one profile."""
        self.cache_manager = manager

    def _priced(self, bandwidths: BandwidthLike) -> BandwidthLike:
        """`bandwidths` minus the optimizer-state write rate
        (opt_bytes_per_step over one profiled step), floored at 1 B/s."""
        if self.opt_bytes_per_step <= 0 or not self.profiles:
            return bandwidths
        t_step = sum(p.fwd_time for p in self.profiles) \
            * (1.0 + self.bwd_factor)
        if t_step <= 0:
            return bandwidths
        rate = self.opt_bytes_per_step / t_step
        if isinstance(bandwidths, (int, float)):
            return max(float(bandwidths) - rate, 1.0)
        return [TierBandwidth(t.name, max(t.write_bw - rate, 1.0),
                              t.capacity_bytes)
                for t in bandwidths]

    def attach_health(self, health) -> None:
        """Subscribe to a `repro_torch.resilience.BackendHealth`: on a
        degraded / failing / recovered transition the policy re-plans
        against the bandwidth the backend can still deliver (failing:
        nothing offloads; stages already offloaded ride the engine's
        recompute fallback)."""
        health.subscribe(self.on_health_event)

    def on_health_event(self, event) -> None:
        """Re-plan mid-run from an I/O worker's thread: a new plan from
        the retained profile at the degraded bandwidth, swapped in under
        a lock (the engine reads it between stages)."""
        with self._replan_lock:
            self.last_health_event = event
            if self.profiles is None or self.bandwidths is None:
                return      # no profile yet: nothing to re-plan from
            if event.kind == "failing":
                scale = 0.0
            elif event.kind == "degraded":
                scale = 1.0 / max(event.latency_ratio, 1.0)
            else:           # recovered
                scale = 1.0
            self.plan = plan_offload(
                self.profiles,
                self._priced(_scale_bandwidths(self.bandwidths, scale)),
                bwd_factor=self.bwd_factor,
                always_keep_last=self.always_keep_last)
            self.replans += 1
            n_off = sum(self.plan.offload)
        if obs.is_enabled():
            obs.count("resilience.replan")
            obs.instant("resilience.replan", cat="resilience",
                        trigger=event.kind, op=event.op,
                        bw_scale=round(scale, 4),
                        stages_offloaded=n_off,
                        latency_ratio=round(event.latency_ratio, 3))

    @property
    def wants_profile(self) -> bool:
        return self.plan is None

    def should_offload(self, stage, profile=None) -> bool:
        if self.plan is None:
            return True      # the profiling step offloads everything it can
        return self.plan.offload[stage]

    def on_profile(self, profiles, bandwidths) -> OffloadPlan:
        self.profiles = list(profiles)
        self.bandwidths = bandwidths
        self.plan = plan_offload(self.profiles, self._priced(bandwidths),
                                 bwd_factor=self.bwd_factor,
                                 always_keep_last=self.always_keep_last)
        if self.cache_manager is not None:
            # reuse distances in seconds: a residual waits about half a
            # step for its backward, an optimizer moment a full step, and
            # a parked KV sequence keeps its default 3x rank
            t_step = sum(p.fwd_time for p in self.profiles) \
                * (1.0 + self.bwd_factor)
            if t_step > 0:
                self.cache_manager.hint_class_distance(
                    "activation", 0.5 * t_step)
                self.cache_manager.hint_class_distance("opt_state", t_step)
                self.cache_manager.hint_class_distance(
                    "kv_page", 3.0 * t_step)
        return self.plan

    def __repr__(self):
        return (f"AdaptivePolicy(bwd_factor={self.bwd_factor}, "
                f"planned={self.plan is not None})")


#: the strategy names the CLI and `resolve_policy` accept
STRATEGIES = ("keep", "offload", "recompute", "adaptive", "spool")


def resolve_policy(policy: Union[OffloadPolicy, str, None] = None
                   ) -> OffloadPolicy:
    """An `OffloadPolicy`, or its name: "keep" / "recompute" / "spool"
    (SpoolPolicy) / "adaptive" / "offload" (the JAX package's default
    meaning, AdaptivePolicy). None means "offload"."""
    if isinstance(policy, OffloadPolicy):
        return policy
    name = "offload" if policy is None else policy
    if not isinstance(name, str) or name not in STRATEGIES:
        raise ValueError(f"unknown offload policy {name!r}; expected an "
                         f"OffloadPolicy or one of {STRATEGIES}")
    return {"keep": KeepPolicy, "recompute": RecomputePolicy,
            "spool": SpoolPolicy, "adaptive": AdaptivePolicy,
            "offload": AdaptivePolicy}[name]()
