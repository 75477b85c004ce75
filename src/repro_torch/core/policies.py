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
(`attach_health`), feeds its profiled step time to a cache manager as
per-class reuse distances (`attach_cache_manager`) and translates its
plan for the jit engine (`plan_for_jit`: a `JitOffloadPlan`, one
profile driving both engines). `opt_bytes_per_step` prices optimizer
traffic that shares the write path when a caller gives it (the JAX
package's `price_opt_io` is not ported: no caller sets it after
profiling).

The jit engine of the port is the staged engine with its placement set
by `RunSettings.activation_policy` (`policy_for_jit`): "keep" is
KeepPolicy, "remat" RecomputePolicy, and "spool" `LayerSpoolPolicy`
(layer stages through the spool, decoder layers as
`RunSettings.spool_stages` marks them). "offload" and "offload_ssd" (the
JAX package's one host-memory tier, `repro/models/transformer.py:
131-155`, `save_and_offload_only_these_names`) are `HostTierPolicy`,
and "save_names" (`save_only_these_names`) `SaveNamesPolicy`: layer
stages are recomputed, and of `RunSettings.offload_names` (the names
the layers mark, `OFFLOAD_NAMES`) the host tier moves a layer stage's
input ("blk_in") and the tensors marked inside the stage ("attn_out",
"mlp_hidden", "moe_hidden"; `models/marks.py`) into pinned host memory
until the stage's backward, while "save_names" keeps the inner ones on
the device (a stage's input is held on the device by every recomputed
stage, so "save_names" of "blk_in" alone is RecomputePolicy). The
recompute then takes each held tensor where it would compute it: with
"attn_out" held it runs no attention forward. No name is remat; a name
outside `OFFLOAD_NAMES` is refused, where JAX ignores it.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.core.adaptive import (BWD_FACTOR, BandwidthLike,
                                       ModuleProfile, OffloadPlan,
                                       TierBandwidth, plan_offload)

#: stage roles whose backward can be recomputed from the module input
RECOMPUTABLE_ROLES = ("layer", "enc_layer")

#: the jit engine's activation placements (RunSettings.activation_policy)
JIT_ACTIVATION_POLICIES = ("keep", "remat", "offload", "offload_ssd",
                           "save_names", "spool")

#: the tensors the layers name for the memory tiers: a layer stage's
#: input, then the marks inside a stage (`models/marks.py`)
OFFLOAD_NAMES = ("blk_in", "attn_out", "mlp_hidden", "moe_hidden")


def _scale_bandwidths(bw: BandwidthLike, scale: float) -> BandwidthLike:
    """Bandwidths as the planner should see them after a health event:
    every tier's write rate scaled by `scale` (0.0 = device gone)."""
    if isinstance(bw, (int, float)):
        return float(bw) * scale
    return [TierBandwidth(t.name, t.write_bw * scale, t.capacity_bytes)
            for t in bw]


def _is_decoder_layer(name: str) -> bool:
    """Stage names: decoder layers are 'seg{si}_l{rep}'."""
    return name.startswith("seg") and "_l" in name


def _is_encoder_layer(name: str) -> bool:
    """Stage names: encoder layers are 'enc{si}_l{rep}'."""
    return name.startswith("enc") and "_l" in name


@dataclass(frozen=True)
class JitOffloadPlan:
    """A profiled plan translated for the jit engine: per-decoder-layer
    keep/offload choices, derived from the same `on_profile` data that
    drives the staged engine.

    `spool_stages[i]` is True when decoder layer i's residuals should go
    through the spool; False keeps them on the device (the staged
    AdaptivePolicy's keep-set). `activation_policy` is what
    `RunSettings.activation_policy` should be: "spool" while any layer
    offloads, else "keep"."""

    spool_stages: Tuple[bool, ...]
    activation_policy: str                     # "spool" | "keep"
    required_bw: float
    write_bw: float
    #: fraction of each layer's profiled bytes the planned shard hands
    #: the spool (1.0 = unsharded; see local_shard_fraction)
    shard_fraction: float = 1.0

    def apply(self, settings):
        """The same RunSettings with this plan's placement choices."""
        return dataclasses.replace(
            settings,
            activation_policy=self.activation_policy,
            spool_stages=(self.spool_stages
                          if self.activation_policy == "spool" else None))


class OffloadPolicy:
    """Base policy: decides, per stage, where residuals live."""

    strategy = "offload"

    #: the engine runs a profiling step (sync-timed stages, wait_io,
    #: calibrate) while this is True
    wants_profile = False

    plan: Optional[OffloadPlan] = None

    #: the engine moves a recomputed stage's input to pinned host memory
    #: until its backward (the host tier)
    host_inputs = False

    #: the names marked inside a recomputed stage that the engine holds
    #: from its forward to its recompute: in pinned host memory with
    #: `inner_on_host`, else on the device
    inner_names: Tuple[str, ...] = ()
    inner_on_host = False

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


def _inner(names: Sequence[str]) -> Tuple[str, ...]:
    """The names of `names` marked inside a stage, checked."""
    names = tuple(names)
    bad = [n for n in names if n not in OFFLOAD_NAMES]
    if bad:
        raise ValueError(
            f"offload_names {names!r}: the layers mark {OFFLOAD_NAMES!r}, "
            f"not {bad!r} (JAX ignores an unknown name, and the tier "
            "then holds nothing it names)")
    return tuple(n for n in names if n != "blk_in")


class HostTierPolicy(RecomputePolicy):
    """The JAX jit engine's host-memory tier ("offload" /
    "offload_ssd"): layer stages are recomputed, as under
    RecomputePolicy, and of `names` each stage's input ("blk_in") and
    the tensors marked inside it wait in pinned host memory from its
    forward to its backward instead of on the device (no spool record,
    backend or file)."""

    strategy = "offload"
    inner_on_host = True

    def __init__(self, names: Sequence[str] = ("blk_in",)):
        self.inner_names = _inner(names)
        self.host_inputs = "blk_in" in names

    def __repr__(self):
        return (f"HostTierPolicy(host_inputs={self.host_inputs}, "
                f"inner_names={self.inner_names})")


class SaveNamesPolicy(RecomputePolicy):
    """The JAX jit engine's "save_names": layer stages are recomputed,
    and the tensors of `names` marked inside a stage stay on the device
    from its forward to its recompute, which takes them in place of
    computing them."""

    def __init__(self, names: Sequence[str]):
        self.inner_names = _inner(names)

    def __repr__(self):
        return f"SaveNamesPolicy(inner_names={self.inner_names})"


class LayerSpoolPolicy(OffloadPolicy):
    """The jit engine's "spool" placement: layer stages go through the
    spool (the JAX jit engine hooks only its scanned layers; embed, head
    and the encoder's ends stay on the device). `spool_stages` masks the
    decoder layers in order (None: all; a layer past its end spools);
    encoder layers always spool, as in the JAX package."""

    strategy = "offload"

    def __init__(self, spool_stages: Optional[Sequence[bool]] = None,
                 decoder_layers: Sequence[str] = ()):
        self.spool_stages = (None if spool_stages is None
                             else tuple(bool(b) for b in spool_stages))
        self._index = {name: i for i, name in enumerate(decoder_layers)}

    def should_offload(self, stage, profile=None) -> bool:
        name = profile.name if profile is not None else ""
        if _is_encoder_layer(name):
            return True
        if not _is_decoder_layer(name):
            return False
        i = self._index.get(name)
        mask = self.spool_stages
        return mask is None or i is None or i >= len(mask) or mask[i]

    def __repr__(self):
        return f"LayerSpoolPolicy(spool_stages={self.spool_stages})"


def policy_for_jit(settings, decoder_layers: Sequence[str] = ()
                   ) -> OffloadPolicy:
    """The staged engine's policy for a jit-engine RunSettings: "keep" ->
    KeepPolicy, "remat" -> RecomputePolicy, "offload" / "offload_ssd" ->
    HostTierPolicy of `settings.offload_names`, "save_names" ->
    SaveNamesPolicy of the names inside a stage, "spool" ->
    LayerSpoolPolicy over `decoder_layers` (the decoder layer stage names
    in order). A tier with no name to hold is RecomputePolicy (remat); a
    name outside OFFLOAD_NAMES raises."""
    name = settings.activation_policy
    if name in ("offload", "offload_ssd", "save_names"):
        names = tuple(settings.offload_names)
        inner = _inner(names)
        if name == "save_names":
            # every recomputed stage keeps its input on the device
            return SaveNamesPolicy(inner) if inner else RecomputePolicy()
        return HostTierPolicy(names) if names else RecomputePolicy()
    if name == "keep":
        return KeepPolicy()
    if name == "remat":
        return RecomputePolicy()
    if name == "spool":
        return LayerSpoolPolicy(settings.spool_stages, decoder_layers)
    raise ValueError(f"unknown activation_policy {name!r}; expected one "
                     f"of {JIT_ACTIVATION_POLICIES}")


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

    def plan_for_jit(self, *, shard_fraction: float = 1.0
                     ) -> JitOffloadPlan:
        """The profiled plan as per-decoder-layer placement for the jit
        engine: one policy object, profiled once (on either engine),
        drives both.

        `shard_fraction` scales the profiled per-layer byte estimates
        before planning: on a mesh every shard spools only its local
        block (the batch split over the dp axes), so the deadline test
        should judge local bytes. `local_shard_fraction` gives the
        fraction a mesh implies; a smaller fraction can only offload
        more layers."""
        if self.plan is None or self.profiles is None:
            raise RuntimeError(
                "plan_for_jit() needs a profiling step first: run one "
                "staged step with this policy (on_profile) before "
                "translating the plan for the jit engine")
        if not 0.0 < shard_fraction <= 1.0:
            raise ValueError(
                f"shard_fraction must be in (0, 1], got {shard_fraction}")
        plan = self.plan
        if shard_fraction != 1.0:
            scaled = [ModuleProfile(p.name,
                                    int(round(p.bytes * shard_fraction)),
                                    p.fwd_time)
                      for p in self.profiles]
            plan = plan_offload(scaled, self._priced(self.bandwidths),
                                bwd_factor=self.bwd_factor,
                                always_keep_last=self.always_keep_last)
        mask = tuple(bool(off)
                     for prof, off in zip(self.profiles, plan.offload)
                     if _is_decoder_layer(prof.name))
        return JitOffloadPlan(
            spool_stages=mask,
            activation_policy="spool" if any(mask) else "keep",
            required_bw=plan.required_bw,
            write_bw=plan.write_bw,
            shard_fraction=shard_fraction)

    def __repr__(self):
        return (f"AdaptivePolicy(bwd_factor={self.bwd_factor}, "
                f"planned={self.plan is not None})")


def local_shard_fraction(mesh, dp_axes=("data",)) -> float:
    """Fraction of a layer's saved bytes one shard hands the spool on a
    mesh: the leading (batch) dim splits over the dp axes, so each shard
    holds 1/dp_size of a batch-major tensor (tp slices shrink a rank's
    bytes further but also multiply writers, leaving the per-host total
    unchanged: dp is the term that scales a shard's deadline)."""
    if mesh is None:
        return 1.0
    n = 1
    for a in (dp_axes or ()):
        if a in mesh.shape:
            n *= int(mesh.shape[a])
    return 1.0 / max(n, 1)


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
