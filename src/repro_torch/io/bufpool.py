"""Aligned, reusable host buffers for the spool's zero-copy data plane,
after the JAX package's `repro/io/bufpool.py`.

Page-aligned `mmap` buffers in power-of-two size classes, leased per
I/O job and returned for reuse, so the steady-state store/load loop
performs no large allocation. Page alignment (4 KiB) is what `O_DIRECT`
descriptors require, so one pool serves the buffered and the direct-I/O
backends.

On a CUDA session (`register_cuda()`), each buffer is also registered
with CUDA as page-locked memory (`cudaHostRegister`), once, when it is
mapped, and unregistered when the pool trims or closes it. A load that
reads into such a lease is a source the host-to-device copy starts from
directly, and a device-to-host copy lands in it asynchronously: the raw
codec's load path makes no host copy at all. Torch's own pinned
allocator is not used for the pool: it rounds sizes its own way and
promises no 4096-byte alignment. A registered pool keeps idle at least
as many bytes as it has had leased at once (`peak_leased_bytes`), above
`max_bytes` if need be: registering a buffer took about 0.3 s a GiB on
an H100 machine (PERF.md §5), so trimming a buffer the next step leases again would pay
that on every lease, while the idle bytes it keeps never exceed what the
data plane held at once.

Leases are explicit (`PooledBuffer.release()`), not GC-driven: a load's
deserialized views borrow the buffer until the spool record is dropped
(and, on the card, until the copy back to the device has run), and
releasing at finalizer time would hand the buffer to a new writer while
those views are still read.
"""
from __future__ import annotations

import mmap
import threading
import time
from typing import Dict, List

import numpy as np

from repro_torch import obs

#: O_DIRECT-compatible default: one x86 page / the common LBA-format size
DEFAULT_ALIGNMENT = 4096


def _size_class(nbytes: int, alignment: int) -> int:
    """Smallest power-of-two multiple of `alignment` holding `nbytes`."""
    cap = alignment
    while cap < nbytes:
        cap <<= 1
    return cap


def _address(mm: mmap.mmap) -> int:
    view = np.frombuffer(mm, dtype=np.uint8, count=1)
    try:
        return view.ctypes.data
    finally:
        del view


def _cudart():
    import torch
    return torch.cuda.cudart()


class PooledBuffer:
    """One leased buffer. `mv` is the full-capacity writable memoryview
    (page-aligned base); `data` is the first `nbytes` of it. `release`
    returns the buffer to the pool: idempotent, and mandatory before the
    memory can be reused."""

    __slots__ = ("_pool", "_mm", "mv", "capacity", "nbytes", "_released")

    def __init__(self, pool: "AlignedBufferPool", mm: mmap.mmap,
                 capacity: int, nbytes: int):
        self._pool = pool
        self._mm = mm
        self.mv = memoryview(mm)
        self.capacity = capacity
        self.nbytes = nbytes
        self._released = False

    @property
    def data(self) -> memoryview:
        return self.mv[:self.nbytes]

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.mv.release()
        self.mv = None
        self._pool._put_back(self._mm, self.capacity)
        self._mm = None

    def __enter__(self) -> "PooledBuffer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()


class AlignedBufferPool:
    """Thread-safe pool of page-aligned buffers in power-of-two size
    classes. `max_bytes` caps the idle (free-list) footprint; buffers
    returned beyond the cap are freed instead of cached. Once registered
    with CUDA the cap is `idle_cap`: the larger of `max_bytes` and the
    most bytes leased at once."""

    def __init__(self, *, alignment: int = DEFAULT_ALIGNMENT,
                 max_bytes: int = 256 << 20):
        if alignment <= 0 or (alignment & (alignment - 1)):
            raise ValueError(f"alignment must be a power of two, "
                             f"got {alignment}")
        if alignment > mmap.PAGESIZE:
            raise ValueError(
                f"alignment {alignment} exceeds the page size "
                f"{mmap.PAGESIZE} that mmap-backed buffers guarantee")
        self.alignment = alignment
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._free: Dict[int, List[mmap.mmap]] = {}
        self._free_bytes = 0
        self._leased_bytes = 0
        self.peak_leased_bytes = 0  # most bytes leased at once
        self.hits = 0
        self.misses = 0
        self.trimmed = 0            # returns dropped over max_bytes
        self.bytes_allocated = 0    # lifetime mmap volume (miss cost)
        self.cuda = False           # register new buffers with CUDA
        self._registered: Dict[int, int] = {}   # id(mmap) -> address
        self.registrations = 0      # cudaHostRegister calls
        self.register_s = 0.0       # seconds spent in them

    def register_cuda(self) -> None:
        """From now on every buffer is registered with CUDA as
        page-locked memory (the idle ones at once, new ones when they are
        mapped). Idempotent."""
        with self._lock:
            if self.cuda:
                return
            self.cuda = True
            idle = [mm for bucket in self._free.values() for mm in bucket]
        for mm in idle:
            self._register(mm)

    def _register(self, mm: mmap.mmap) -> None:
        cudart = _cudart()
        addr = _address(mm)
        t0 = time.perf_counter()
        err = cudart.cudaHostRegister(addr, len(mm), 0)
        dt = time.perf_counter() - t0
        if err != cudart.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of a {len(mm)}-byte "
                               f"pool buffer failed: {err}")
        with self._lock:
            self._registered[id(mm)] = addr
            self.registrations += 1
            self.register_s += dt

    def _free_map(self, mm: mmap.mmap) -> None:
        """Unregister (if registered) and unmap one buffer."""
        with self._lock:
            addr = self._registered.pop(id(mm), None)
        if addr is not None:
            _cudart().cudaHostUnregister(addr)
        try:
            mm.close()
        except BufferError:
            pass    # a borrower still holds a view; GC reclaims the map

    def acquire(self, nbytes: int) -> PooledBuffer:
        """Lease a buffer of capacity >= max(nbytes, alignment)."""
        cap = _size_class(max(nbytes, 1), self.alignment)
        with self._lock:
            self._leased_bytes += cap
            self.peak_leased_bytes = max(self.peak_leased_bytes,
                                         self._leased_bytes)
            bucket = self._free.get(cap)
            if bucket:
                mm = bucket.pop()
                self._free_bytes -= cap
                self.hits += 1
                obs.count("pool.hit")
                return PooledBuffer(self, mm, cap, nbytes)
            self.misses += 1
            self.bytes_allocated += cap
            cuda = self.cuda
        obs.count("pool.miss")
        # a miss is a fresh mmap whose pages fault on first touch (and,
        # on the card, a registration): it earns a timeline mark
        obs.instant("pool.miss", cat="pool", bytes=cap)
        mm = mmap.mmap(-1, cap)
        if cuda:
            self._register(mm)
        return PooledBuffer(self, mm, cap, nbytes)

    @property
    def idle_cap(self) -> int:
        """The idle bytes kept: `max_bytes`, raised on a registered pool
        to the most bytes leased at once."""
        if self.cuda:
            return max(self.max_bytes, self.peak_leased_bytes)
        return self.max_bytes

    def _put_back(self, mm: mmap.mmap, cap: int) -> None:
        with self._lock:
            self._leased_bytes -= cap
            if self._free_bytes + cap <= self.idle_cap:
                self._free.setdefault(cap, []).append(mm)
                self._free_bytes += cap
                return
            self.trimmed += 1
        obs.count("pool.trim")
        self._free_map(mm)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def free_bytes(self) -> int:
        with self._lock:
            return self._free_bytes

    def stats(self) -> Dict[str, float]:
        return {
            "hits": self.hits, "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "trimmed": self.trimmed,
            "free_bytes": self.free_bytes,
            "idle_cap": self.idle_cap,
            "peak_leased_bytes": self.peak_leased_bytes,
            "bytes_allocated": self.bytes_allocated,
            "alignment": self.alignment,
            "registrations": self.registrations,
            "register_s": round(self.register_s, 4),
        }

    def close(self) -> None:
        """Free every idle buffer (leased ones are released by their
        holders)."""
        with self._lock:
            buckets, self._free = self._free, {}
            self._free_bytes = 0
        for bucket in buckets.values():
            for mm in bucket:
                self._free_map(mm)
