"""Storage-backend interface of the port's activation spool, a copy of
the JAX package's `repro/io/backend.py` (the nominal-rate table, which
only the dryrun reads, waits for it): a key/value blob store with
measured per-backend I/O volume, busy time and host-copy accounting.
Each write and read is an `io.write` / `io.read` span carrying the key,
the backend kind and the bytes, as in the JAX package, so the overlap
analyzer matches a fetch's wait to its read by key.

The data plane is vectored and copy-accounted: `write_parts` moves a
serde part list to the device without a monolithic join, `readinto`
fills a caller-owned (pooled) buffer instead of allocating a fresh blob,
and `IoStats.bytes_copied` counts every host-side payload copy the path
could not avoid. `delete` is missing-tolerant, matching the spool's
unconditional drop. Backends register under string keys
(`register_backend`) so configs and CLI specs select them by name
(`repro_torch.io.factory`).

`classify_io_error` is the retry layer's taxonomy: which failures a
bounded retry may ride out (transient) and which it cannot (fatal).
"""
from __future__ import annotations

import abc
import errno
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Type

from repro_torch import obs
from repro_torch.core.adaptive import TierBandwidth
from repro_torch.obs.overlap import IO_SPANS

_WRITE_SPAN, _READ_SPAN = IO_SPANS

# ------------------------------------------------------- error taxonomy
#
#   transient — the device is still there but momentarily unhappy
#               (interrupted syscall, contended queue, a flaky-media
#               EIO): a bounded retry with backoff routinely succeeds.
#   fatal     — retrying cannot help: the blob is gone (ENOENT), the
#               device is gone or read-only (ENODEV/EROFS/EACCES), the
#               filesystem is out of space (ENOSPC: freeing space is a
#               placement decision, not a retry), or the payload itself
#               is malformed (serde ValueError on a torn blob).

#: errno values a bounded retry may ride out
TRANSIENT_ERRNOS = frozenset({
    errno.EINTR, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT, errno.EIO,
    errno.ENOBUFS, errno.ENOMEM,
})

#: errno values where retrying the same call is pointless
FATAL_ERRNOS = frozenset({
    errno.ENOENT, errno.ENOSPC, errno.ENODEV, errno.ENXIO, errno.EROFS,
    errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
})


def classify_io_error(exc: BaseException) -> str:
    """``"transient"`` or ``"fatal"``. An `OSError` without a listed
    errno is transient (one retry is cheap; losing a step is not); what
    is not an OSError (a serde ValueError on a truncated blob, a
    KeyError) is fatal, because the bytes are wrong, not the device."""
    if isinstance(exc, FileNotFoundError):
        return "fatal"
    if isinstance(exc, OSError):
        if exc.errno in FATAL_ERRNOS:
            return "fatal"
        return "transient"
    if isinstance(exc, (TimeoutError, InterruptedError)):
        return "transient"
    return "fatal"


# Nominal sequential-write rates (bytes/s) of storage devices per backend
# kind, which the dry run's projections use where nothing is measured
# yet (the JAX package's `repro/io/backend.py:97-105`): rates of storage,
# not of a chip, carried across as they are. fs: one datacenter NVMe;
# striped: the paper's 4x D7-P5810 array; mem / tiered: host DRAM over
# PCIe 4.0 x16; aio: one NVMe through O_DIRECT, with no page-cache copy.
# `cache/manager.py` adds "managed" at the tiered rate.
NOMINAL_WRITE_BW: Dict[str, float] = {
    "fs": 2.0e9,
    "striped": 8.0e9,
    "mem": 20.0e9,
    "tiered": 20.0e9,
    "aio": 3.0e9,
}


@dataclass
class IoStats:
    """Bytes and busy time per direction. write_time / read_time are
    utilization clocks: time during which at least one writer (reader)
    was inside the backend, so N concurrent spool threads do not count
    N-fold. bytes_copied counts host-side payload copies (joins, bounce
    and staging buffers), not the device transfer itself."""
    bytes_written: int = 0
    bytes_read: int = 0
    write_time: float = 0.0
    read_time: float = 0.0
    num_writes: int = 0
    num_reads: int = 0
    num_deletes: int = 0
    bytes_copied: int = 0

    @property
    def write_bandwidth(self) -> float:
        return self.bytes_written / self.write_time \
            if self.write_time else float("inf")

    @property
    def read_bandwidth(self) -> float:
        return self.bytes_read / self.read_time \
            if self.read_time else float("inf")

    def as_dict(self) -> Dict[str, float]:
        moved = self.bytes_written + self.bytes_read
        return {
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
            "write_time_s": self.write_time,
            "read_time_s": self.read_time,
            "num_writes": self.num_writes,
            "num_reads": self.num_reads,
            "write_gb_s": (self.write_bandwidth / 1e9
                           if self.write_time else None),
            "read_gb_s": (self.read_bandwidth / 1e9
                          if self.read_time else None),
            "bytes_copied": self.bytes_copied,
            "copies_per_byte": self.bytes_copied / moved if moved else 0.0,
        }


def as_memoryviews(parts) -> List[memoryview]:
    """Normalize a part list to flat byte memoryviews without copying."""
    out = []
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.itemsize != 1 or mv.ndim != 1:
            mv = mv.cast("B")
        out.append(mv)
    return out


_IOV_MAX = 1024


def pwritev_all(fd: int, parts: List[memoryview], offset: int = 0) -> int:
    """`os.pwritev` the whole part list at `offset`, riding out partial
    writes and the IOV_MAX batch cap. Returns the end offset."""
    queue = [p for p in parts if len(p)]
    while queue:
        written = os.pwritev(fd, queue[:_IOV_MAX], offset)
        if written <= 0:
            raise OSError(f"pwritev stalled at offset {offset}")
        offset += written
        while queue and written >= len(queue[0]):
            written -= len(queue[0])
            queue.pop(0)
        if queue and written:
            queue[0] = queue[0][written:]
    return offset


def preadv_all(fd: int, buf: memoryview, offset: int = 0) -> int:
    """Fill `buf` from `fd` starting at `offset`; stops early only at
    EOF. Returns bytes read."""
    got = 0
    while got < len(buf):
        n = os.preadv(fd, [buf[got:]], offset + got)
        if n <= 0:
            break
        got += n
    return got


def blob_name(key: str) -> str:
    """A key as one file name: a mesh lease's ``jit3/s1_s2`` keeps its
    ``/`` out of the path (escaped as ``%2F``, ``%`` as ``%25``); any
    other key is its own name, so blobs stay the JAX package's."""
    return key.replace("%", "%25").replace("/", "%2F")


def key_of(name: str) -> str:
    """`blob_name` undone."""
    return name.replace("%2F", "/").replace("%25", "%")


class StorageBackend(abc.ABC):
    """Subclasses implement `_write`, `_read` and `_delete` (and may
    override the vectored `_write_parts` / `_readinto` and `_size`); the
    public methods time them into `stats`."""

    #: registry key, set by @register_backend
    kind: str = "?"

    #: True when `read` hands back the stored blob itself with no copy
    #: (RAM-backed stores): pooled loaders then skip the readinto
    #: staging buffer and deserialize straight over the returned blob
    zero_copy_read: bool = False

    def __init__(self) -> None:
        self.stats = IoStats()
        self._stats_lock = threading.Lock()
        self._active = {"w": 0, "r": 0}
        self._window_start = {"w": 0.0, "r": 0.0}

    def _enter(self, side: str) -> None:
        with self._stats_lock:
            if self._active[side] == 0:
                self._window_start[side] = time.perf_counter()
            self._active[side] += 1

    def _exit(self, side: str) -> float:
        now = time.perf_counter()
        with self._stats_lock:
            self._active[side] -= 1
            if self._active[side] == 0:
                return now - self._window_start[side]
            return 0.0

    def _count(self, side: str, nbytes: int, dt: float) -> None:
        with self._stats_lock:
            if side == "w":
                self.stats.bytes_written += nbytes
                self.stats.write_time += dt
                self.stats.num_writes += 1
            else:
                self.stats.bytes_read += nbytes
                self.stats.read_time += dt
                self.stats.num_reads += 1

    # ------------------------------------------------------- public API

    def write(self, key: str, data) -> None:
        self._enter("w")
        try:
            with obs.span(_WRITE_SPAN, cat="io", key=key, kind=self.kind,
                          bytes=len(data)):
                self._write(key, data)
        finally:
            dt = self._exit("w")
        self._count("w", len(data), dt)

    def write_parts(self, key: str, parts) -> None:
        """Vectored write: the blob as a list of bytes-like parts, moved
        to the device without a monolithic join where the backend has a
        scatter path (else one counted join)."""
        parts = as_memoryviews(parts)
        nbytes = sum(len(p) for p in parts)
        self._enter("w")
        try:
            with obs.span(_WRITE_SPAN, cat="io", key=key, kind=self.kind,
                          bytes=nbytes):
                self._write_parts(key, parts)
        finally:
            dt = self._exit("w")
        self._count("w", nbytes, dt)

    def read(self, key: str) -> bytes:
        self._enter("r")
        try:
            with obs.span(_READ_SPAN, cat="io", key=key,
                          kind=self.kind) as sp:
                data = self._read(key)
                sp.set(bytes=len(data))
        finally:
            dt = self._exit("r")
        self._count("r", len(data), dt)
        return data

    def readinto(self, key: str, buf) -> memoryview:
        """Read the blob into the caller's buffer (typically a pooled
        aligned one) and return the filled prefix: no per-load blob
        allocation. `buf` must hold at least `size(key)` bytes."""
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        self._enter("r")
        try:
            with obs.span(_READ_SPAN, cat="io", key=key,
                          kind=self.kind) as sp:
                n = self._readinto(key, mv)
                sp.set(bytes=n)
        finally:
            dt = self._exit("r")
        self._count("r", n, dt)
        return mv[:n]

    def size(self, key: str) -> Optional[int]:
        """Stored blob size in bytes, or None when the backend cannot
        answer without reading (callers then fall back to `read`)."""
        return self._size(key)

    def delete(self, key: str) -> None:
        self._delete(key)
        with self._stats_lock:
            self.stats.num_deletes += 1

    def keys(self) -> List[str]:
        """Keys currently stored (for leak checks)."""
        raise NotImplementedError

    def flush(self) -> None:
        """Durability barrier; a no-op for backends without buffering."""

    def reset_stats(self) -> None:
        """Start a fresh measurement window (before a calibration burst,
        so tier bandwidths reflect only uncontended writes)."""
        with self._stats_lock:
            self.stats = IoStats()

    def calibrate(self, data, repeats: int = 2) -> None:
        """Measure write bandwidth with a synthetic burst: reset stats,
        write `repeats` copies of `data`, delete them. Composite backends
        override this to exercise every tier (a tier the burst never
        reaches would report infinite bandwidth to the planner)."""
        self.reset_stats()
        for i in range(repeats):
            self.write(f"_calibrate{i}", data)
        for i in range(repeats):
            self.delete(f"_calibrate{i}")

    def close(self) -> None:
        """Release what the backend holds open; data stays stored."""
        self.flush()

    def tier_bandwidths(self) -> List[TierBandwidth]:
        """Measured per-tier write bandwidth for the adaptive planner:
        one unbounded tier for a flat backend; tiered stores expose
        their capacity-bounded upper tier first."""
        return [TierBandwidth(self.kind, self.stats.write_bandwidth, None)]

    # ---------------------------------------------------- to implement

    def _note_copy(self, nbytes: int) -> None:
        """Record an unavoidable host-side payload copy."""
        with self._stats_lock:
            self.stats.bytes_copied += nbytes

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        """Default scatter path: join once (counted) and defer to
        `_write`."""
        data = b"".join(parts)
        self._note_copy(len(data))
        self._write(key, data)

    def _readinto(self, key: str, buf: memoryview) -> int:
        """Default gather path: `_read`, then one counted copy into the
        caller's buffer."""
        data = self._read(key)
        n = len(data)
        if n > len(buf):
            raise ValueError(f"buffer of {len(buf)} bytes cannot hold "
                             f"{n}-byte blob {key!r}")
        buf[:n] = data
        self._note_copy(n)
        return n

    def _size(self, key: str) -> Optional[int]:
        return None

    @abc.abstractmethod
    def _write(self, key: str, data) -> None: ...

    @abc.abstractmethod
    def _read(self, key: str) -> bytes: ...

    @abc.abstractmethod
    def _delete(self, key: str) -> None: ...


# ---------------------------------------------------------------- registry

BACKENDS: Dict[str, Type[StorageBackend]] = {}


def register_backend(name: str):
    def deco(cls: Type[StorageBackend]) -> Type[StorageBackend]:
        cls.kind = name
        BACKENDS[name] = cls
        return cls
    return deco


def get_backend_cls(name: str) -> Type[StorageBackend]:
    if name == "managed" and name not in BACKENDS:
        # the cache manager registers itself on import; it imports this
        # module, so it cannot be imported at the top of it
        import repro_torch.cache.manager  # noqa: F401
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown storage backend {name!r}; "
                       f"registered: {sorted(BACKENDS)}") from None
