"""Tier-placement engine, a copy of the JAX package's
`repro/cache/placement.py`: one protocol serves both the static
`tiered` backend and the class-aware `CacheManager`.

The engine owns placement of keyed blobs across an upper (host-RAM)
store bounded by `capacity_bytes` and an unbounded lower (SSD) store.
The invariants are unchanged from the tiered backend that grew them:

  * victims are chosen under the lock, spilled OUTSIDE it (lower-tier
    writes are the slow part; serializing every store thread behind one
    eviction would reduce the hierarchy to single-threaded SSD speed);
  * a spill writes lower BEFORE deleting upper, so a concurrent read
    always finds the blob on one side without taking the lock;
  * oversize blobs (> capacity) bypass RAM, waiting out any in-flight
    migration of their key first;
  * deletes of mid-migration keys are completed by the migrating thread
    (`_kill`), and a key re-written while its old blob spills is
    detected (`readmitted`) so the stale copy never shadows fresh data.

New over the tiered original: a pluggable victim policy (`victim_fn` —
the CacheManager plugs in reuse-distance ordering; default is FIFO
front-pop, Belady's choice under the spool's LIFO access pattern), an
upward migration (`promote`, the demotion protocol run in reverse for
blobs the reuse horizon says are needed soon), exact per-tier byte
accounting (`_lowered` carries sizes, `peak_resident_bytes` records the
high-water pinned-host footprint for the MemAscend-style bound), and an
optional `fallback_to_upper` mode where a failing lower tier degrades
to host-RAM residency instead of losing data.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch import obs


class PlacementEngine:
    def __init__(self, upper, lower, *, capacity_bytes: int,
                 victim_fn: Optional[Callable] = None,
                 fallback_to_upper: bool = False,
                 note_copy: Optional[Callable[[int], None]] = None,
                 on_lower_error: Optional[
                     Callable[[BaseException], None]] = None):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.upper = upper
        self.lower = lower
        self.capacity_bytes = capacity_bytes
        self.victim_fn = victim_fn
        self.fallback_to_upper = fallback_to_upper
        self._note_copy = note_copy or (lambda n: None)
        # failing-lower-tier observer (CacheManager feeds BackendHealth)
        self.on_lower_error = on_lower_error
        self._lock = threading.Lock()
        self._migration_done = threading.Condition(self._lock)
        # key -> nbytes, in store order (front = default evict-first)
        self._resident: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._spilling: set = set()      # victims mid-flight to lower
        self._promoting: set = set()     # keys mid-flight to upper
        self._kill: set = set()          # deleted while spilling
        self._lowered: Dict[str, int] = {}   # key -> nbytes in lower
        self._resident_bytes = 0         # running sum of _resident
        self.peak_resident_bytes = 0
        self.evictions = 0
        self.bytes_evicted = 0
        self.promotions = 0
        self.bytes_promoted = 0
        self.fallbacks = 0
        self.bytes_fallback = 0

    # ------------------------------------------------------ accounting

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    @property
    def lowered_bytes(self) -> int:
        with self._lock:
            return sum(self._lowered.values())

    def tier_items(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Snapshot of (upper, lower) key -> nbytes maps."""
        with self._lock:
            return dict(self._resident), dict(self._lowered)

    def _admit_locked(self, key: str, nbytes: int) -> None:
        prev = self._resident.pop(key, 0)
        self._resident[key] = nbytes
        self._resident_bytes += nbytes - prev
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self._resident_bytes)

    def _pick_victim(self) -> str:
        if self.victim_fn is not None:
            k = self.victim_fn(self._resident)
            if k is not None:
                return k
        return next(iter(self._resident))

    # ------------------------------------------------------- put / get

    def put(self, key: str, nbytes: int, put: Callable,
            ram_copy: bool = False) -> None:
        """Place a payload: `put(tier)` lands it on the chosen store.
        `ram_copy` marks a part-list payload whose RAM placement joins
        (one host copy), reported through `note_copy` so the owner's
        copies-per-byte stays honest; lower-tier copies live on the
        lower store's own stats."""
        if nbytes > self.capacity_bytes:
            self._put_oversize(key, nbytes, put)
            return
        with self._lock:
            victims = []
            while self._resident and \
                    self._resident_bytes + nbytes > self.capacity_bytes:
                k = self._pick_victim()
                nb = self._resident.pop(k)
                self._resident_bytes -= nb
                self._spilling.add(k)
                victims.append(k)
            put(self.upper)
            if ram_copy:
                self._note_copy(nbytes)
            self._admit_locked(key, nbytes)
            # a stale lower copy from an earlier oversize lease of this
            # key must not outlive the resident-only delete path
            stale_lower = self._lowered.pop(key, None) is not None
        if stale_lower:
            self.lower.delete(key)
        for k in victims:
            self._spill(k)

    def _put_oversize(self, key: str, nbytes: int, put: Callable) -> None:
        # Oversize blobs bypass RAM. Wait out any in-flight migration of
        # this key first — a migrator's stale copy must neither clobber
        # nor delete the new lower-tier blob — and claim the key out of
        # _resident so no evictor picks it up meanwhile.
        with self._migration_done:
            while key in self._spilling or key in self._promoting:
                self._migration_done.wait()
            nb = self._resident.pop(key, None)
            if nb is not None:
                self._resident_bytes -= nb
            self._lowered[key] = nbytes
        try:
            put(self.lower)
        except Exception as e:
            if self.on_lower_error is not None:
                self.on_lower_error(e)
            if not self.fallback_to_upper:
                with self._migration_done:
                    self._lowered.pop(key, None)
                raise
            # degraded lower tier: hold the blob in host RAM even over
            # budget — losing an activation loses the step
            with self._migration_done:
                self._lowered.pop(key, None)
            put(self.upper)
            with self._migration_done:
                self._admit_locked(key, nbytes)
                self.fallbacks += 1
                self.bytes_fallback += nbytes
            obs.count("cache.fallback")
            return
        if nb is not None:
            self.upper.delete(key)

    def _spill(self, k: str) -> None:
        """Demote one chosen victim (outside the lock; see module doc)."""
        try:
            blob = self.upper.read(k)
        except FileNotFoundError:
            with self._migration_done:
                self._spilling.discard(k)
                self._kill.discard(k)
                self._migration_done.notify_all()
            return
        try:
            with obs.span("cache.demote", cat="cache", key=str(k),
                          bytes=len(blob)):
                # write lower BEFORE deleting upper, so a concurrent
                # read always finds the blob on one side
                self.lower.write(k, blob)
        except Exception as e:
            if self.on_lower_error is not None:
                self.on_lower_error(e)
            with self._migration_done:
                self._spilling.discard(k)
                killed = k in self._kill
                self._kill.discard(k)
                readmitted = k in self._resident
                if self.fallback_to_upper and not (killed or readmitted):
                    # lower tier failing: re-admit at evict-first
                    # position — the blob stays host-resident (possibly
                    # over budget) rather than lost
                    self._resident[k] = len(blob)
                    self._resident.move_to_end(k, last=False)
                    self._resident_bytes += len(blob)
                    self.peak_resident_bytes = max(
                        self.peak_resident_bytes, self._resident_bytes)
                    self.fallbacks += 1
                    self.bytes_fallback += len(blob)
                self._migration_done.notify_all()
            if killed and not readmitted:
                self.upper.delete(k)
            if not self.fallback_to_upper:
                raise
            obs.count("cache.fallback")
            return
        with self._migration_done:
            self._spilling.discard(k)
            killed = k in self._kill
            self._kill.discard(k)
            # spool keys are reused across steps: the key may have been
            # re-written (a fresh resident blob) while we were spilling
            # the old one
            readmitted = k in self._resident
            if not (killed or readmitted):
                self._lowered[k] = len(blob)
            self.evictions += 1
            self.bytes_evicted += len(blob)
            self._migration_done.notify_all()
        if killed or readmitted:
            # our spilled copy is stale — it must not shadow the
            # re-admitted blob (or survive a drop)
            self.lower.delete(k)
            if killed and not readmitted:
                self.upper.delete(k)
        else:
            self.upper.delete(k)

    def promote(self, key: str) -> bool:
        """Migrate one lowered blob back to the upper tier (the reuse
        horizon says it is needed soon). Best-effort: returns False
        without side effects when the key is gone, already resident,
        mid-migration, or would not fit the budget."""
        with self._lock:
            nb = self._lowered.get(key)
            if nb is None or key in self._resident \
                    or key in self._spilling or key in self._promoting:
                return False
            if self._resident_bytes + nb > self.capacity_bytes:
                return False
            self._promoting.add(key)
        try:
            with obs.span("cache.promote", cat="cache", key=str(key),
                          bytes=nb):
                blob = self.lower.read(key)
        except Exception:
            with self._migration_done:
                self._promoting.discard(key)
                self._migration_done.notify_all()
            return False
        claimed = False
        with self._lock:
            # deleted or re-written while we were reading?
            if key in self._lowered and key not in self._resident \
                    and self._resident_bytes + len(blob) \
                    <= self.capacity_bytes:
                # RAM-store insert: cheap enough to hold the lock, and
                # it keeps read()'s find-it-on-one-side guarantee
                self.upper.write(key, blob)
                del self._lowered[key]
                self._admit_locked(key, len(blob))
                self.promotions += 1
                self.bytes_promoted += len(blob)
                claimed = True
        if claimed:
            self.lower.delete(key)
        with self._migration_done:
            self._promoting.discard(key)
            self._migration_done.notify_all()
        return claimed

    # ---------------------------------------------------------- reads

    def read(self, key: str) -> bytes:
        # Try RAM first and fall through on miss: a migration always
        # keeps the blob on at least one side (see module doc)
        try:
            return self.upper.read(key)
        except FileNotFoundError:
            return self.lower.read(key)

    def readinto(self, key: str, buf: memoryview) -> int:
        try:
            return len(self.upper.readinto(key, buf))
        except FileNotFoundError:
            return len(self.lower.readinto(key, buf))

    def size(self, key: str) -> Optional[int]:
        with self._lock:
            nb = self._resident.get(key)
            if nb is None:
                nb = self._lowered.get(key)
        if nb is not None:
            return nb
        # mid-migration: the same upper-then-lower order as reads
        n = self.upper.size(key)
        return n if n is not None else self.lower.size(key)

    def delete(self, key: str) -> None:
        with self._lock:
            nb = self._resident.pop(key, None)
            resident = nb is not None
            if resident:
                self._resident_bytes -= nb
            spilling = key in self._spilling
            if spilling:
                self._kill.add(key)    # the spiller finishes the delete
            lowered = self._lowered.pop(key, None) is not None
        if resident:
            self.upper.delete(key)
        if not spilling and (lowered or not resident):
            self.lower.delete(key)
