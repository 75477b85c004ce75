"""Adaptive offloading planner (paper §3.3.3, Figure 8), copied from the
JAX package's `repro/core/adaptive.py`.

Profile the first training step to collect, per module (here: per scanned
super-layer), the residual bytes and forward compute time, plus the measured
spool write bandwidth. Then pick the *last module to offload* m as the
largest m such that the aggregate transfer deadline holds:

    bytes(m)   = sum_{j<m} store_j + (store_m + load_m)
    deadline(m)= t_fwd_total - t_fwd_end(m)            (rest of forward)
                 + bwd_factor * sum_{j>m} t_fwd_j      (bwd of later modules)
    required_bw(m) = bytes(m) / deadline(m)  <=  write_bandwidth

with the paper's estimate bwd_factor = 2 (backward ~ 2x forward). Modules
after m are kept in GPU memory — they are the first ones needed when the
backward pass begins, so offloading them cannot reduce the peak (offloading
tensors after the peak is not helpful) and only delays memory reclaim.

Tiered storage: instead of a single scalar, the planner also
accepts a sequence of `TierBandwidth` entries — the measured write
bandwidth and byte capacity of each storage tier, fastest first (e.g.
host-RAM budget over an SSD array). The feasibility test then compares
against `effective_write_bandwidth`, the byte-weighted aggregate rate of
filling the tiers in order with the candidate plan's traffic: a plan
whose bytes fit the RAM tier is judged at RAM speed; one that spills is
judged at the blended rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

BWD_FACTOR = 2.0


@dataclass(frozen=True)
class TierBandwidth:
    """One storage tier as the planner sees it: measured write bandwidth
    (bytes/s) and capacity (None = unbounded, e.g. a filesystem)."""
    name: str
    write_bw: float
    capacity_bytes: Optional[int] = None


#: what plan_offload accepts as its bandwidth argument
BandwidthLike = Union[float, Sequence[TierBandwidth]]


def effective_write_bandwidth(tiers: Sequence[TierBandwidth],
                              total_bytes: float) -> float:
    """Aggregate write bandwidth for `total_bytes` filling `tiers` in
    order. Bytes overflowing every finite capacity land on the last
    tier (treated as unbounded — there is always a bottom of the
    hierarchy)."""
    if not tiers:
        return 0.0
    if total_bytes <= 0:
        return tiers[0].write_bw
    remaining = float(total_bytes)
    t = 0.0
    for i, tier in enumerate(tiers):
        last = i == len(tiers) - 1
        cap = (remaining if (last or tier.capacity_bytes is None)
               else min(tier.capacity_bytes, remaining))
        if cap <= 0:
            continue
        if tier.write_bw <= 0:
            return 0.0
        t += cap / tier.write_bw
        remaining -= cap
        if remaining <= 0:
            break
    if t <= 0:
        return float("inf")
    return total_bytes / t


@dataclass(frozen=True)
class ModuleProfile:
    name: str
    bytes: int          # residual bytes this module would offload
    fwd_time: float     # seconds of forward compute


@dataclass(frozen=True)
class OffloadPlan:
    offload: List[bool]          # per module
    required_bw: float           # bytes/s needed for the chosen plan
    write_bw: float              # measured bytes/s
    last_offloaded: int          # index m (-1: nothing offloaded)

    @property
    def num_offloaded(self) -> int:
        return sum(self.offload)


def required_bandwidth(profiles: Sequence[ModuleProfile], m: int,
                       bwd_factor: float = BWD_FACTOR) -> float:
    """Bandwidth needed if modules 0..m (inclusive) are offloaded."""
    if m < 0:
        return 0.0
    bytes_needed = plan_bytes(profiles, m)
    t_fwd_rest = sum(p.fwd_time for p in profiles[m + 1:])
    t_bwd_later = bwd_factor * sum(p.fwd_time for p in profiles[m + 1:])
    # transfers for modules 0..m can also use the time while they execute:
    t_fwd_own = sum(p.fwd_time for p in profiles[1:m + 1])
    deadline = t_fwd_own + t_fwd_rest + t_bwd_later
    if deadline <= 0:
        return float("inf")
    return bytes_needed / deadline


def plan_bytes(profiles: Sequence[ModuleProfile], m: int) -> int:
    """Total transfer bytes if modules 0..m are offloaded (stores for
    0..m plus the reload of module m before its backward)."""
    if m < 0:
        return 0
    return sum(p.bytes for p in profiles[:m]) + 2 * profiles[m].bytes


def _bw_for(write_bw: BandwidthLike, nbytes: float) -> float:
    if isinstance(write_bw, (int, float)):
        return float(write_bw)
    return effective_write_bandwidth(write_bw, nbytes)


def plan_offload(profiles: Sequence[ModuleProfile],
                 write_bw: BandwidthLike,
                 bwd_factor: float = BWD_FACTOR,
                 always_keep_last: bool = True) -> OffloadPlan:
    """Choose the largest feasible last-offloaded module (paper's rule).

    `write_bw` is a scalar bytes/s, or a fastest-first sequence of
    `TierBandwidth` (repro.io tiered backends): each candidate plan is
    judged against the effective bandwidth of its own byte volume."""
    n = len(profiles)
    hi = n - 2 if always_keep_last else n - 1  # last module kept (§3.2 ④)
    best = -1
    for m in range(hi, -2, -1):
        if m < 0:
            break
        avail = _bw_for(write_bw, plan_bytes(profiles, m))
        if required_bandwidth(profiles, m, bwd_factor) <= avail:
            best = m
            break
    offload = [i <= best for i in range(n)]
    return OffloadPlan(
        offload=offload,
        required_bw=required_bandwidth(profiles, best, bwd_factor),
        write_bw=_bw_for(write_bw, plan_bytes(profiles, best)),
        last_offloaded=best,
    )
