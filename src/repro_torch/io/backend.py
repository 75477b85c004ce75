"""Storage-backend interface of the port's activation spool, trimmed
from the JAX package's `repro/io/backend.py` (no planner tiers): a
key/value blob store with measured per-backend I/O volume and busy time.
Each write and read is an `io.write` / `io.read` span carrying the key,
the backend kind and the bytes, as in the JAX package, so the overlap
analyzer matches a fetch's wait to its read by key.

`write_parts` takes the blob as a list of bytes-like parts (the serde
part list), so the filesystem backend writes it with `os.pwritev` and no
join. `delete` is missing-tolerant, matching the spool's unconditional
drop.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List

from repro_torch import obs
from repro_torch.obs.overlap import IO_SPANS

_WRITE_SPAN, _READ_SPAN = IO_SPANS

@dataclass
class IoStats:
    """Bytes and busy time per direction. write_time / read_time are
    utilization clocks: time during which at least one writer (reader)
    was inside the backend, so N concurrent spool threads do not count
    N-fold."""
    bytes_written: int = 0
    bytes_read: int = 0
    write_time: float = 0.0
    read_time: float = 0.0
    num_writes: int = 0
    num_reads: int = 0
    num_deletes: int = 0


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


class StorageBackend:
    """Subclasses implement `_write_parts`, `_read` and `_delete`; the
    public methods time them into `stats`."""

    kind: str = "?"

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

    def write_parts(self, key: str, parts) -> None:
        parts = as_memoryviews(parts)
        nbytes = sum(len(p) for p in parts)
        self._enter("w")
        try:
            with obs.span(_WRITE_SPAN, cat="io", key=key, kind=self.kind,
                          bytes=nbytes):
                self._write_parts(key, parts)
        finally:
            dt = self._exit("w")
        with self._stats_lock:
            self.stats.bytes_written += nbytes
            self.stats.write_time += dt
            self.stats.num_writes += 1

    def read(self, key: str) -> bytes:
        self._enter("r")
        try:
            with obs.span(_READ_SPAN, cat="io", key=key,
                          kind=self.kind) as sp:
                data = self._read(key)
                sp.set(bytes=len(data))
        finally:
            dt = self._exit("r")
        with self._stats_lock:
            self.stats.bytes_read += len(data)
            self.stats.read_time += dt
            self.stats.num_reads += 1
        return data

    def delete(self, key: str) -> None:
        self._delete(key)
        with self._stats_lock:
            self.stats.num_deletes += 1

    def keys(self) -> List[str]:
        """Keys currently stored (for leak checks)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release what the backend holds open; data stays stored."""

    def _write_parts(self, key: str, parts: List[memoryview]) -> None:
        raise NotImplementedError

    def _read(self, key: str) -> bytes:
        raise NotImplementedError

    def _delete(self, key: str) -> None:
        raise NotImplementedError
