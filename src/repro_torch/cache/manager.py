"""CacheManager — the cost-model-driven storage brain over pinned-host-RAM
/ SSD for every tensor class the spool carries, a copy of the JAX
package's `repro/cache/manager.py`.

The manager places every blob by its *class* and predicted *reuse
distance* over the same `PlacementEngine` (`repro_torch.cache.placement`)
the static `tiered` backend uses:

  activation  residuals, reused within the step in backward order —
              the spool's LIFO pattern, nearest reuse
  opt_state   optimizer moments staged between steps — reused exactly
              one step later (step parity)
  kv_page     evicted KV pages of parked sequences — reused when the
              sequence re-enters the scheduler's refill horizon,
              typically farthest of the three

Classes are recognised by lease-key prefix (``opt{step}_*``,
``kv{rid}_*``; everything else is an activation) and clients can
register their own. Eviction picks the earliest-stored blob of the
farthest-reuse class (Belady's choice under per-class access order),
never a blob on the hinted reuse horizon; `hint_next` — fed by the same
`reuse_horizon` prefix the prefetchers act on — marks imminent reuse
and queues background *promotion* of lowered blobs back into host RAM
when the calibrated `TierBandwidth` numbers say the SSD read would
otherwise be the slower path. The pinned-host tier is bounded by
`host_bound_bytes` (MemAscend's pinned-memory footprint concern made a
hard knob: `peak_host_bytes` must never exceed it), and a failing SSD
tier degrades to host-RAM residency instead of losing data
(`fallback_to_upper`).

The manager IS a `StorageBackend` (kind ``"managed"``), so the
existing spool data plane (bufpool, vectored writes, aio lower tiers)
and the transactional lease contract carry over unchanged; training,
fine-tuning, and serving share one brain by sharing one backend.
"""
from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.cache.placement import PlacementEngine
from repro_torch.core.adaptive import TierBandwidth

#: nominal reuse-distance rank per class (unitless ordering; larger =
#: reused farther in the future = evicted earlier). AdaptivePolicy
#: overwrites the activation entry with measured per-step seconds.
DEFAULT_CLASS_DISTANCES = {
    "activation": 1.0,
    "opt_state": 2.0,
    "kv_page": 3.0,
}

_DEFAULT_PREFIXES = (("opt", "opt_state"), ("kv", "kv_page"))


@dataclass(frozen=True)
class CacheConfig:
    """Knobs of the storage brain (the ``--cache-*`` CLI family)."""
    host_bound_bytes: int = 256 << 20   # MemAscend-style pinned bound
    promote_depth: int = 2              # hinted keys promoted per hint
    promote: bool = True                # background promotion on/off
    hint_capacity: int = 512            # live hinted-key window

    def validate(self) -> "CacheConfig":
        assert self.host_bound_bytes >= 0, self.host_bound_bytes
        assert self.promote_depth >= 0, self.promote_depth
        assert self.hint_capacity >= 1, self.hint_capacity
        return self


@dataclass
class ClassStats:
    bytes_written: int = 0
    writes: int = 0


# register under the backend registry so spec strings ("managed:64mb")
# and SpoolIoConfig(backend="managed") resolve like any other kind
from repro_torch.io.backend import (NOMINAL_WRITE_BW,  # noqa: E402
                                    StorageBackend, register_backend)
from repro_torch.io.backends import HostMemoryBackend  # noqa: E402

NOMINAL_WRITE_BW.setdefault("managed", NOMINAL_WRITE_BW.get("tiered",
                                                            20e9))


@register_backend("managed")
class CacheManager(StorageBackend):
    def __init__(self, lower: StorageBackend, *,
                 config: Optional[CacheConfig] = None,
                 host_bound_bytes: Optional[int] = None,
                 upper: Optional[HostMemoryBackend] = None):
        super().__init__()
        if config is None:
            config = CacheConfig()
        if host_bound_bytes is not None:
            config = CacheConfig(
                host_bound_bytes=host_bound_bytes,
                promote_depth=config.promote_depth,
                promote=config.promote,
                hint_capacity=config.hint_capacity)
        self.config = config.validate()
        self.upper = upper if upper is not None else HostMemoryBackend()
        self.lower = lower
        self.engine = PlacementEngine(
            self.upper, lower,
            capacity_bytes=self.config.host_bound_bytes,
            victim_fn=self._pick_victim,
            fallback_to_upper=True,
            note_copy=self._note_copy)
        self._cls_lock = threading.Lock()
        self._distances = dict(DEFAULT_CLASS_DISTANCES)
        self._prefixes: List[Tuple[str, str]] = list(_DEFAULT_PREFIXES)
        self._by_class: Dict[str, ClassStats] = {}
        self._hinted: "OrderedDict[str, bool]" = OrderedDict()
        self.host_hits = 0
        self.ssd_hits = 0
        self.hints = 0
        self._promo_q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._promo_thread = None
        if self.config.promote:
            self._promo_thread = threading.Thread(
                target=self._promo_worker, daemon=True,
                name="cache-promote")
            self._promo_thread.start()

    def attach_health(self, health) -> None:
        """Report failing lower-tier (SSD) writes into a
        `repro_torch.resilience.BackendHealth`, so tier fallbacks show up as
        degradation events next to spool retry failures. The fallback
        itself already happened (the blob stayed host-resident) — this
        only makes the demotion visible to re-planning subscribers."""
        def note(exc: BaseException) -> None:
            health.record_failure("write", exc)
        self.engine.on_lower_error = note

    # back-compat with TieredBackend duck-typing (benchmarks, planner)
    @property
    def capacity_bytes(self) -> int:
        return self.config.host_bound_bytes

    @property
    def resident_bytes(self) -> int:
        return self.engine.resident_bytes

    @property
    def peak_host_bytes(self) -> int:
        return self.engine.peak_resident_bytes

    # ------------------------------------------------- class registry

    def register_class(self, name: str, *, prefix: Optional[str] = None,
                       distance: Optional[float] = None) -> None:
        """Declare a tensor class: keys starting with `prefix` belong to
        it (None: the default 'activation' bucket) at nominal reuse
        `distance`. Idempotent — clients call this unconditionally."""
        with self._cls_lock:
            if distance is not None:
                self._distances[name] = float(distance)
            else:
                self._distances.setdefault(
                    name, DEFAULT_CLASS_DISTANCES.get(name, 1.0))
            if prefix is not None:
                pairs = [p for p in self._prefixes if p[1] != name
                         or p[0] == prefix]
                if (prefix, name) not in pairs:
                    pairs.append((prefix, name))
                # longest prefix wins the classification scan
                self._prefixes = sorted(pairs, key=lambda p: -len(p[0]))

    def hint_class_distance(self, name: str, distance: float) -> None:
        """Update a class's measured reuse distance (e.g. AdaptivePolicy
        feeding profiled seconds-until-backward for activations)."""
        with self._cls_lock:
            self._distances[name] = float(distance)

    def classify(self, key: str) -> str:
        s = str(key)
        for prefix, name in self._prefixes:
            if s.startswith(prefix):
                return name
        return "activation"

    # -------------------------------------------------- reuse signals

    def hint_next(self, keys: Sequence[str]) -> None:
        """The caller's reuse horizon: these keys are needed soonest.
        Hinted keys are protected from eviction, and lowered ones are
        queued for background promotion (bounded by `promote_depth`)
        when the tier bandwidths price the promotion as a win."""
        promoted = 0
        with self._cls_lock:
            for key in keys:
                key = str(key)
                self._hinted.pop(key, None)
                self._hinted[key] = True
                self.hints += 1
                while len(self._hinted) > self.config.hint_capacity:
                    self._hinted.popitem(last=False)
        if self._promo_thread is not None:
            for key in keys:
                if promoted >= self.config.promote_depth:
                    break
                self._promo_q.put(str(key))
                promoted += 1

    def note_access(self, key: str) -> None:
        with self._cls_lock:
            self._hinted.pop(str(key), None)

    def _pick_victim(self, resident: "OrderedDict[str, int]") \
            -> Optional[str]:
        """Evict the earliest-stored blob of the farthest-reuse class,
        skipping the hinted horizon. Iteration is insertion order, so
        the first key of a class seen is that class's farthest reuse
        under the spool's LIFO access pattern. Called under the engine
        lock; falls back to FIFO when everything resident is hinted."""
        with self._cls_lock:
            hinted = self._hinted
            distances = self._distances
            max_d = max(distances.values()) if distances else 1.0
            best_k, best_d = None, float("-inf")
            for k in resident:
                if k in hinted:
                    continue
                d = distances.get(self.classify(k), 1.0)
                if d > best_d:
                    best_k, best_d = k, d
                    if d >= max_d:
                        break
        return best_k        # None -> engine FIFO fallback

    def _promotion_pays(self, nbytes: int) -> bool:
        """Price the move with measured tier bandwidths: promoting only
        pays when the eventual read would come off a lower tier that is
        slower than host RAM. Unmeasured tiers (no traffic yet) are
        priced optimistically — the first fetches calibrate them."""
        low = self.lower.stats
        up = self.upper.stats
        lower_bw = low.read_bandwidth if low.read_time else \
            low.write_bandwidth
        upper_bw = up.write_bandwidth
        if lower_bw <= 0 or upper_bw <= 0:
            return True
        return lower_bw < upper_bw

    def _promo_worker(self) -> None:
        while True:
            key = self._promo_q.get()
            if key is None:
                return
            try:
                nb = self.engine.size(key)
                if nb is not None and self._promotion_pays(nb):
                    self.engine.promote(key)
            except Exception:
                pass            # best-effort background migration

    # ------------------------------------------------ StorageBackend

    def _note_write(self, key: str, nbytes: int) -> None:
        cls = self.classify(key)
        with self._cls_lock:
            st = self._by_class.setdefault(cls, ClassStats())
            st.bytes_written += nbytes
            st.writes += 1
        if obs.is_enabled():
            obs.gauge("cache.host_bytes", self.engine.resident_bytes)

    def _write(self, key: str, data: bytes) -> None:
        # a pre-joined blob is stored by reference in RAM: no join copy
        self.engine.put(key, len(data),
                        lambda tier: tier.write(key, data))
        self._note_write(key, len(data))

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        nbytes = sum(len(p) for p in parts)
        self.engine.put(key, nbytes,
                        lambda tier: tier.write_parts(key, parts),
                        ram_copy=True)
        self._note_write(key, nbytes)

    def _read(self, key: str) -> bytes:
        self.note_access(key)
        try:
            data = self.upper.read(key)
            self.host_hits += 1
            return data
        except FileNotFoundError:
            data = self.lower.read(key)
            self.ssd_hits += 1
            return data

    def _readinto(self, key: str, buf: memoryview) -> int:
        self.note_access(key)
        try:
            n = len(self.upper.readinto(key, buf))
            self.host_hits += 1
            return n
        except FileNotFoundError:
            n = len(self.lower.readinto(key, buf))
            self.ssd_hits += 1
            return n

    def _size(self, key: str) -> Optional[int]:
        return self.engine.size(key)

    def _delete(self, key: str) -> None:
        self.note_access(key)
        self.engine.delete(key)

    def keys(self) -> List[str]:
        return sorted(set(self.upper.keys()) | set(self.lower.keys()))

    def flush(self) -> None:
        self.lower.flush()

    def reset_stats(self) -> None:
        super().reset_stats()
        self.upper.reset_stats()
        self.lower.reset_stats()

    def calibrate(self, data: bytes, repeats: int = 2) -> None:
        """Burst both tiers (same rationale as the tiered backend: a
        small burst fits the RAM budget, so the lower tier would read
        as infinitely fast if only the front door were measured)."""
        self.reset_stats()
        for i in range(repeats):
            self.upper.write(f"_calibrate{i}", data)
        for i in range(repeats):
            self.upper.delete(f"_calibrate{i}")
        self.lower.calibrate(data, repeats)

    def close(self) -> None:
        if self._promo_thread is not None:
            self._promo_q.put(None)
            self._promo_thread.join(timeout=5.0)
            self._promo_thread = None
        self.lower.close()

    def tier_bandwidths(self) -> List[TierBandwidth]:
        up = TierBandwidth("host-ram", self.upper.stats.write_bandwidth,
                           self.config.host_bound_bytes)
        return [up] + self.lower.tier_bandwidths()

    # -------------------------------------------------- observability

    def residency(self) -> Dict[str, Dict[str, int]]:
        """Exact per-tier, per-class resident bytes right now."""
        upper, lowered = self.engine.tier_items()
        out: Dict[str, Dict[str, int]] = {"host-ram": {}, "ssd": {}}
        for k, nb in upper.items():
            cls = self.classify(k)
            out["host-ram"][cls] = out["host-ram"].get(cls, 0) + nb
        for k, nb in lowered.items():
            cls = self.classify(k)
            out["ssd"][cls] = out["ssd"].get(cls, 0) + nb
        return out

    def cache_stats(self) -> Dict[str, object]:
        """Flat counters + residency snapshot (the `cache_*` block's
        source; monotonic counters are diffed per step by the
        session)."""
        e = self.engine
        res = self.residency()
        stats = {
            "host_bytes": sum(res["host-ram"].values()),
            "ssd_bytes": sum(res["ssd"].values()),
            "host_peak_bytes": e.peak_resident_bytes,
            "host_bound_bytes": self.config.host_bound_bytes,
            "evictions": e.evictions,
            "bytes_evicted": e.bytes_evicted,
            "promotions": e.promotions,
            "bytes_promoted": e.bytes_promoted,
            "fallbacks": e.fallbacks,
            "bytes_fallback": e.bytes_fallback,
            "host_hits": self.host_hits,
            "ssd_hits": self.ssd_hits,
            "hints": self.hints,
            "residency": res,
        }
        if obs.is_enabled():
            obs.gauge("cache.host_bytes", stats["host_bytes"])
            obs.gauge("cache.ssd_bytes", stats["ssd_bytes"])
            for cls, nb in res["host-ram"].items():
                obs.gauge(f"cache.host_bytes.{cls}", nb)
        return stats

    #: counters in cache_stats() that are diffed into per-step deltas;
    #: everything else is a point-in-time gauge
    MONOTONIC = ("evictions", "bytes_evicted", "promotions",
                 "bytes_promoted", "fallbacks", "bytes_fallback",
                 "host_hits", "ssd_hits", "hints")

    def metrics_delta(self, prev: Optional[Dict[str, object]]) \
            -> Tuple[Dict[str, object], Dict[str, object]]:
        """(per-step cache block, new snapshot): counters are deltas
        against `prev`, residency/peak fields pass through as gauges."""
        cur = self.cache_stats()
        block = dict(cur)
        if prev:
            for k in self.MONOTONIC:
                block[k] = cur[k] - prev.get(k, 0)
        return block, cur


def plan_residency(class_bytes: Dict[str, int], *,
                   host_bound_bytes: int,
                   distances: Optional[Dict[str, float]] = None) \
        -> Dict[str, Dict[str, int]]:
    """Predicted steady-state placement: classes claim the bounded
    pinned-host tier in ascending reuse-distance order (nearest reuse
    keeps RAM); whatever overflows the MemAscend-style bound lands on
    SSD. Shares the manager's class-distance table, so a prediction
    pairs key for key with the measured `cache_*` residency in the
    metrics JSONL."""
    d = dict(DEFAULT_CLASS_DISTANCES)
    if distances:
        d.update(distances)
    room = max(0, int(host_bound_bytes))
    out: Dict[str, Dict[str, int]] = {}
    for cls, nbytes in sorted(class_bytes.items(),
                              key=lambda kv: (d.get(kv[0], 1.0), kv[0])):
        nbytes = max(0, int(nbytes))
        take = min(room, nbytes)
        out[cls] = {"host_ram_bytes": take, "ssd_bytes": nbytes - take}
        room -= take
    return out
