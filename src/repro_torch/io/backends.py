"""The port's storage backends, a copy of the JAX package's
`repro/io/backends.py`: one directory (`fs`, the stand-in for one SSD),
chunk striping across directories (`striped`, the paper's multi-SSD
array), host RAM (`mem`) and the capacity-budgeted RAM-over-SSD tier
(`tiered`). Blob files are the JAX package's byte for byte (`{key}.act`,
stripe chunks `{key}.c{i}` placed by crc32), so either package reads the
other's. `keys()` lists what a backend holds, for leak checks."""
from __future__ import annotations

import errno
import os
import threading
import zlib
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.cache.placement import PlacementEngine
from repro_torch.core.adaptive import TierBandwidth
from repro_torch.io.backend import (StorageBackend, as_memoryviews,
                                    preadv_all, pwritev_all,
                                    register_backend)


@register_backend("fs")
class FilesystemBackend(StorageBackend):
    """One blob file per key in one directory — the seed ActivationSpool
    path, extracted. The directory stands in for a single SSD.

    Writes are vectored (`os.pwritev` over the serde part list, no
    monolithic join) and rename-atomic: the blob lands in a
    same-directory temp file that is `os.replace`d over the real name
    only once fully written, so a *process* crash mid-store can never
    leave a truncated blob under the final name for
    `deserialize_leaves` to misparse on restart. (Power loss is weaker:
    without a per-store fsync — unaffordable per residual — the journal
    may commit the rename before the data lands; serde's truncation
    guard then rejects the torn blob loudly instead.) Reads can scatter
    straight into a caller-owned buffer (`readinto`)."""

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.act")

    def _tmp_path(self, key: str) -> str:
        # pid+tid suffix: concurrent writers of *different* keys (the
        # spool's store pool) must not collide on temp names
        return (self._path(key)
                + f".tmp.{os.getpid()}.{threading.get_ident()}")

    def _write(self, key: str, data: bytes) -> None:
        self._write_parts(key, as_memoryviews([data]))

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        tmp = self._tmp_path(key)
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            pwritev_all(fd, parts)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        os.replace(tmp, self._path(key))

    def _read(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def _readinto(self, key: str, buf: memoryview) -> int:
        fd = os.open(self._path(key), os.O_RDONLY)
        try:
            n = os.fstat(fd).st_size
            if n > len(buf):
                raise ValueError(f"buffer of {len(buf)} bytes cannot "
                                 f"hold {n}-byte blob {key!r}")
            got = preadv_all(fd, buf[:n])
            if got != n:
                raise OSError(f"short read of {key!r}: {got}/{n} bytes")
            return got
        finally:
            os.close(fd)

    def _size(self, key: str) -> Optional[int]:
        try:
            return os.stat(self._path(key)).st_size
        except OSError:
            return None

    def _delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def keys(self) -> List[str]:
        return sorted(f[:-len(".act")] for f in os.listdir(self.directory)
                      if f.endswith(".act"))


@register_backend("striped")
class StripedBackend(StorageBackend):
    """Chunk striping across N directories, with capacity/health-aware
    rebalancing.

    Each directory stands in for one SSD of the paper's per-GPU array
    (§3.4 uses 4x D7-P5810). A blob is split into `chunk_bytes` chunks;
    chunk i *prefers* device ((crc32(key) + i) % N), so sequential
    writes load all devices evenly and reads fan out across the array.
    Per-device byte counters are what a per-drive wear model reads (the
    JAX package's `core.endurance.project_device_lifespans`; the port's
    waits for the Fig. 9 slice).

    Resilience: a chunk write that fails is retried on the next-best
    healthy device (ordered by free bytes), and the *actual* placement
    is recorded in the per-key manifest so reads, sizes and deletes
    follow the chunk wherever it landed. A device accumulates
    consecutive write failures; at `fail_threshold` it is taken out of
    the write set (ENOSPC takes it out immediately — a full drive does
    not get healthier by retrying). `set_device_error` is the chaos
    seam: it makes every chunk write *and read* on that device raise,
    as if the NVMe dropped off the bus. Wear accounting only ever
    counts bytes that a device actually accepted.
    """

    def __init__(self, directories: Sequence[str], *,
                 chunk_bytes: int = 4 << 20,
                 fail_threshold: int = 2):
        super().__init__()
        if not directories:
            raise ValueError("StripedBackend needs >= 1 directory")
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.directories = list(directories)
        self.chunk_bytes = chunk_bytes
        self.fail_threshold = fail_threshold
        for d in self.directories:
            os.makedirs(d, exist_ok=True)
        n = len(self.directories)
        self.device_write_bytes = [0] * n
        self.device_read_bytes = [0] * n
        self.rebalanced_chunks = 0
        self.chunk_write_failures = 0
        self._dev_lock = threading.Lock()
        self._fail_counts = [0] * n
        self._down_writes = [False] * n   # out of the write set
        self._forced_exc: Dict[int, BaseException] = {}  # chaos seam
        # key -> device index per chunk (rebuilt by probing if missing)
        self._manifest: Dict[str, List[int]] = {}

    def _device(self, key: str, i: int) -> int:
        # Start each key's round-robin at a key-dependent device (stable
        # crc32, not salted hash()): otherwise every blob smaller than
        # chunk_bytes would land on device 0 and the "array" would wear
        # and bottleneck like a single drive.
        start = zlib.crc32(key.encode()) % len(self.directories)
        return (start + i) % len(self.directories)

    def _path_on(self, dev: int, key: str, i: int) -> str:
        return os.path.join(self.directories[dev], f"{key}.c{i}")

    def _chunk_path(self, key: str, i: int) -> str:
        # default (pre-rebalance) placement; kept for back-compat
        return self._path_on(self._device(key, i), key, i)

    # --------------------------------------------- device health seams

    def set_device_error(self, dev: int, exc: BaseException) -> None:
        """Chaos seam: device `dev` raises `exc` on every chunk write
        and read until `clear_device_error` — a hard device loss."""
        with self._dev_lock:
            self._forced_exc[dev] = exc
            self._down_writes[dev] = True

    def clear_device_error(self, dev: int) -> None:
        """The device came back: readmit it to the write set."""
        with self._dev_lock:
            self._forced_exc.pop(dev, None)
            self._down_writes[dev] = False
            self._fail_counts[dev] = 0

    def devices_down(self) -> List[bool]:
        with self._dev_lock:
            return list(self._down_writes)

    def free_device_bytes(self, dev: int) -> int:
        """Free bytes on device `dev`'s filesystem (0 when down)."""
        with self._dev_lock:
            if self._down_writes[dev] or dev in self._forced_exc:
                return 0
        try:
            st = os.statvfs(self.directories[dev])
            return st.f_bavail * st.f_frsize
        except OSError:
            return 0

    def _forced(self, dev: int) -> Optional[BaseException]:
        with self._dev_lock:
            exc = self._forced_exc.get(dev)
        if exc is None:
            return None
        try:  # fresh instance: concurrent raisers must not share one
            return type(exc)(*exc.args)
        except TypeError:
            return exc

    def _note_write_failure(self, dev: int, exc: BaseException) -> None:
        went_down = False
        with self._dev_lock:
            self.chunk_write_failures += 1
            self._fail_counts[dev] += 1
            full = (isinstance(exc, OSError)
                    and exc.errno == errno.ENOSPC)
            if not self._down_writes[dev] and (
                    full or self._fail_counts[dev] >= self.fail_threshold):
                self._down_writes[dev] = True
                went_down = True
        if went_down and obs.is_enabled():
            obs.instant("resilience.device_down", cat="resilience",
                        dev=dev, dir=self.directories[dev],
                        error=repr(exc))

    def _candidate_order(self, key: str, i: int) -> List[int]:
        """Devices to try for chunk (key, i): the default placement
        first if it is healthy, then the other healthy devices by free
        bytes (fullest last). With the whole array down, fall back to
        the default device so the caller sees the real error."""
        default = self._device(key, i)
        with self._dev_lock:
            healthy = [d for d in range(len(self.directories))
                       if not self._down_writes[d]]
        if not healthy:
            return [default]
        order = [d for d in healthy if d == default]
        rest = [d for d in healthy if d != default]
        rest.sort(key=lambda d: (-self.free_device_bytes(d),
                                 (d - default) % len(self.directories)))
        return order + rest

    # ------------------------------------------------------ write path

    def _write(self, key: str, data: bytes) -> None:
        self._write_parts(key, as_memoryviews([data]))

    def _write_chunk(self, dev: int, key: str, i: int,
                     views: List[memoryview]) -> None:
        forced = self._forced(dev)
        if forced is not None:
            raise forced
        path = self._path_on(dev, key, i)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            pwritev_all(fd, views)
        except BaseException:
            os.close(fd)
            try:  # never leave a torn chunk for the probe to find
                os.unlink(path)
            except OSError:
                pass
            raise
        os.close(fd)

    def _place_chunk(self, key: str, i: int,
                     views: List[memoryview]) -> int:
        nbytes = sum(len(v) for v in views)
        default = self._device(key, i)
        last_exc: Optional[BaseException] = None
        for dev in self._candidate_order(key, i):
            try:
                self._write_chunk(dev, key, i, views)
            except (OSError, ValueError) as e:
                self._note_write_failure(dev, e)
                last_exc = e
                continue
            with self._dev_lock:
                self.device_write_bytes[dev] += nbytes
                self._fail_counts[dev] = 0
                if dev != default:
                    self.rebalanced_chunks += 1
            if dev != default and obs.is_enabled():
                obs.count("resilience.rebalance")
                obs.instant("resilience.rebalance", cat="resilience",
                            key=key, chunk=i, frm=default, to=dev)
            return dev
        assert last_exc is not None
        raise last_exc

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        # Partition the part list into per-chunk view lists: memoryview
        # slicing is zero-copy, so each stripe chunk is pwritev'd from
        # the original serde buffers without assembling the blob or the
        # chunk anywhere on the host.
        chunks: List[List[memoryview]] = [[]]
        room = self.chunk_bytes
        for p in parts:
            while len(p):
                take = min(room, len(p))
                chunks[-1].append(p[:take])
                p = p[take:]
                room -= take
                if room == 0:
                    chunks.append([])
                    room = self.chunk_bytes
        if len(chunks) > 1 and not chunks[-1]:
            chunks.pop()
        n = len(chunks)
        placement: List[int] = []
        for i, views in enumerate(chunks):
            placement.append(self._place_chunk(key, i, views))
        with self._dev_lock:
            self._manifest[key] = placement
        ndirs = len(self.directories)
        # a re-write must not leave stale copies behind: a rebalanced
        # chunk may have MOVED devices, and a shorter blob leaves a
        # tail — either way the probe-based reader (fresh process over
        # the same stripe dirs) would pick up stale chunks, and delete
        # would leak them
        for j, dev in enumerate(placement):
            for d in range(ndirs):
                if d != dev:
                    try:
                        os.unlink(self._path_on(d, key, j))
                    except OSError:
                        pass
        j = n
        while True:
            found = False
            for d in range(ndirs):
                try:
                    os.unlink(self._path_on(d, key, j))
                    found = True
                except OSError:
                    pass
            if not found:
                break
            j += 1

    # ------------------------------------------------------- read path

    def _locate(self, key: str, i: int,
                dev_hint: Optional[int] = None) -> Optional[int]:
        """Find which device holds chunk (key, i): manifest hint first,
        then default placement, then a full probe (fresh process)."""
        order: List[int] = []
        for d in ([dev_hint] if dev_hint is not None else []) \
                + [self._device(key, i)] \
                + list(range(len(self.directories))):
            if d not in order:
                order.append(d)
        for d in order:
            if os.path.exists(self._path_on(d, key, i)):
                return d
        return None

    def _placement(self, key: str) -> List[int]:
        with self._dev_lock:
            p = self._manifest.get(key)
        if p is not None:
            return p
        placement: List[int] = []
        while True:
            d = self._locate(key, len(placement))
            if d is None:
                return placement
            placement.append(d)

    def _read_chunk_fd(self, dev: int, key: str, i: int) -> int:
        forced = self._forced(dev)
        if forced is not None:
            raise forced
        return os.open(self._path_on(dev, key, i), os.O_RDONLY)

    def _read(self, key: str) -> bytes:
        placement = self._placement(key)
        if not placement:
            raise FileNotFoundError(key)
        parts = []
        for i, dev in enumerate(placement):
            fd = self._read_chunk_fd(dev, key, i)
            with os.fdopen(fd, "rb") as f:
                chunk = f.read()
            parts.append(chunk)
            with self._dev_lock:
                self.device_read_bytes[dev] += len(chunk)
        return b"".join(parts)

    def _readinto(self, key: str, buf: memoryview) -> int:
        """Gather the stripe chunks directly into successive slices of
        the caller's buffer — no per-chunk bytes objects, no join."""
        placement = self._placement(key)
        if not placement:
            raise FileNotFoundError(key)
        off = 0
        for i, dev in enumerate(placement):
            fd = self._read_chunk_fd(dev, key, i)
            try:
                sz = os.fstat(fd).st_size
                if off + sz > len(buf):
                    raise ValueError(
                        f"buffer of {len(buf)} bytes cannot hold "
                        f"striped blob {key!r} (>= {off + sz} bytes)")
                got = preadv_all(fd, buf[off:off + sz])
                if got != sz:
                    raise OSError(f"short read of {key!r} chunk {i}: "
                                  f"{got}/{sz} bytes")
            finally:
                os.close(fd)
            with self._dev_lock:
                self.device_read_bytes[dev] += sz
            off += sz
        return off

    def _size(self, key: str) -> Optional[int]:
        placement = self._placement(key)
        if not placement:
            return None
        total = 0
        for i, dev in enumerate(placement):
            try:
                total += os.stat(self._path_on(dev, key, i)).st_size
            except OSError:
                return None
        return total

    def _delete(self, key: str) -> None:
        with self._dev_lock:
            self._manifest.pop(key, None)
        ndirs = len(self.directories)
        i = 0
        while True:  # probe-based: catches stale/moved copies too
            found = False
            for d in range(ndirs):
                try:
                    os.unlink(self._path_on(d, key, i))
                    found = True
                except OSError:
                    pass
            if not found:
                break
            i += 1

    def per_device_write_bytes(self) -> List[int]:
        with self._dev_lock:
            return list(self.device_write_bytes)

    def keys(self) -> List[str]:
        """Keys with any chunk file on any device (stale chunks too)."""
        out = set()
        for d in self.directories:
            for f in os.listdir(d):
                key, dot, idx = f.rpartition(".c")
                if dot and idx.isdigit():
                    out.add(key)
        return sorted(out)


@register_backend("mem")
class HostMemoryBackend(StorageBackend):
    """CPU-RAM tier: blobs live in a host-side dict. On its own it is the
    fastest tier (no serialization to media); under `TieredBackend` it is
    the bounded upper level of the hierarchy."""

    #: `_read` returns the stored bytes object itself — loaders can
    #: deserialize views straight over it (immutable, refcount-kept)
    zero_copy_read = True

    def __init__(self):
        super().__init__()
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    # _write_parts/_readinto: the base-class fallbacks (join + counted
    # copy; read + counted copy into the caller's buffer) ARE this
    # backend's native semantics — RAM is the storage medium, so the
    # join is the device write itself, honestly counted as a host copy.

    def _write(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = data

    def _read(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[key]
            except KeyError:
                raise FileNotFoundError(key) from None

    def _size(self, key: str) -> Optional[int]:
        with self._lock:
            data = self._blobs.get(key)
        return len(data) if data is not None else None

    def _delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blobs.values())

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._blobs)


@register_backend("tiered")
class TieredBackend(StorageBackend):
    """Host-RAM upper tier under a byte budget, spilling to a lower
    backend (10Cache-style heterogeneous hierarchy).

    Writes land in RAM while the budget holds; when a write would exceed
    `capacity_bytes`, resident blobs are evicted to the lower backend in
    *backward-access order*: the backward pass consumes keys in reverse
    store order, so the earliest-stored keys are the ones needed furthest
    in the future — they are evicted first (Belady's choice under the
    spool's LIFO access pattern). Blobs larger than the whole budget
    bypass RAM entirely.

    The placement protocol itself lives in
    `repro_torch.cache.placement.PlacementEngine`; this class is the static
    (class-blind, FIFO-victim, no-promotion) configuration of it, kept
    for configs that want the fixed byte-budget split without the
    `CacheManager`'s reuse-distance machinery.
    """

    def __init__(self, lower: StorageBackend, *, capacity_bytes: int,
                 upper: Optional[HostMemoryBackend] = None):
        super().__init__()
        self.upper = upper if upper is not None else HostMemoryBackend()
        self.lower = lower
        self.capacity_bytes = capacity_bytes
        self._engine = PlacementEngine(
            self.upper, lower, capacity_bytes=capacity_bytes,
            note_copy=self._note_copy)

    @property
    def resident_bytes(self) -> int:
        return self._engine.resident_bytes

    @property
    def evictions(self) -> int:
        return self._engine.evictions

    @property
    def bytes_evicted(self) -> int:
        return self._engine.bytes_evicted

    def _write(self, key: str, data: bytes) -> None:
        # a pre-joined blob is stored by reference in RAM: no join copy
        self._engine.put(key, len(data),
                         lambda tier: tier.write(key, data))

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        # ram_copy: a part-list payload's RAM placement joins (one host
        # copy) — counted on THIS backend's stats too, so the tiered
        # copies-per-byte number stays honest; lower-tier copies live on
        # the lower backend's own stats
        self._engine.put(key, sum(len(p) for p in parts),
                         lambda tier: tier.write_parts(key, parts),
                         ram_copy=True)

    def _read(self, key: str) -> bytes:
        return self._engine.read(key)

    def _readinto(self, key: str, buf: memoryview) -> int:
        return self._engine.readinto(key, buf)

    def _size(self, key: str) -> Optional[int]:
        return self._engine.size(key)

    def _delete(self, key: str) -> None:
        self._engine.delete(key)

    def keys(self) -> List[str]:
        return sorted(set(self.upper.keys()) | set(self.lower.keys()))

    def flush(self) -> None:
        self.lower.flush()

    def reset_stats(self) -> None:
        super().reset_stats()
        self.upper.reset_stats()
        self.lower.reset_stats()

    def calibrate(self, data: bytes, repeats: int = 2) -> None:
        """Burst both tiers: a small burst fits the RAM budget, so the
        lower tier would never be measured (and would read as infinitely
        fast to the planner) if we only wrote through the front door."""
        self.reset_stats()
        for i in range(repeats):
            self.upper.write(f"_calibrate{i}", data)
        for i in range(repeats):
            self.upper.delete(f"_calibrate{i}")
        self.lower.calibrate(data, repeats)

    def close(self) -> None:
        self.lower.close()

    def tier_bandwidths(self) -> List[TierBandwidth]:
        up = TierBandwidth("host-ram", self.upper.stats.write_bandwidth,
                           self.capacity_bytes)
        return [up] + self.lower.tier_bandwidths()
