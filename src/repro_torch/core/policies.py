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

Not ported yet (they wait for resilience, the cache manager, the
optimizer overlap and the jit engine): health-driven re-planning, cache
manager hints, optimizer-I/O pricing and the jit-engine plan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from repro_torch.core.adaptive import (BWD_FACTOR, BandwidthLike,
                                       ModuleProfile, OffloadPlan,
                                       plan_offload)

#: stage roles whose backward can be recomputed from the module input
RECOMPUTABLE_ROLES = ("layer", "enc_layer")


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
    measured store bandwidth can hold."""

    strategy = "offload"

    def __init__(self, *, bwd_factor: float = BWD_FACTOR,
                 always_keep_last: bool = True):
        self.bwd_factor = bwd_factor
        self.always_keep_last = always_keep_last
        self.plan = None
        self.profiles: Optional[List[ModuleProfile]] = None
        self.bandwidths: Optional[BandwidthLike] = None

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
        self.plan = plan_offload(self.profiles, bandwidths,
                                 bwd_factor=self.bwd_factor,
                                 always_keep_last=self.always_keep_last)
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
