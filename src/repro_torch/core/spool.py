"""ActivationSpool — the tensor cache's I/O engine (paper §3.2-3.3.2),
ported from the JAX package's `repro/core/spool.py`.

Two FIFO thread pools, store and load:

  * offload(key, tree): enqueue an async store. Parameters (by storage,
    `core/ids.py`), tensors under `min_offload_elements` and duplicates
    of live tracked tensors stay in memory (recorded, not written). CUDA
    leaves are copied on a side stream into one lease of the spool's
    aligned buffer pool, laid out as the blob itself (with the raw codec
    the store writes that lease as one part, so aio writes straight from
    it); the store worker waits on that copy's event before it reads
    them, and the device memory returns to the allocator once the copy
    is done (`record_stream`), never before;
  * keep(key, tree): record a tree that stays where it is, with the same
    drop and accounting lifecycle (adaptive offloading keeps the last
    modules on device, §3.3.3);
  * prefetch(key): enqueue an async load (a record still in memory
    waits for its fetch, which forwards it);
  * fetch(key): blocking. If the store is still queued or in flight (or
    failed), the in-memory copy is forwarded (§3.3.2) and a still-queued
    store is cancelled (§3.3.3 feature 1). Records that came from the
    card come back to it through a host-to-device copy on a side stream
    that the caller's stream waits on, in the layout they were saved
    with (a permuted layout is restored; a view with gaps comes back
    contiguous);
  * step(id) / lease(id): a transactional lease over records
    (`SpoolStepTransaction`); closing it drops every record it still
    holds, on success and on error.

The pooled load path: a load sizes the blob, reads it with `readinto`
into a leased page-aligned pool buffer and deserializes zero-copy views
over it. On a CUDA session the pool registers its buffers with CUDA as
page-locked memory, so with the raw codec the views are the source of
the copy back to the card and the load makes no host copy; a decoding
codec (zlib, byteplane) produces fresh memory, so its lease goes back at
once and only those payloads are pinned before the copy. A lease goes
back to the pool only when its record is dropped and, on the card, once
the copy back to the device has run (its event): the next load's
`readinto` must never overwrite bytes the card has not read yet. On the
CPU the views would become the graph's saved tensors, so `fetch` copies
them once (as the JAX package's fetch copies its read-only views).

Resilience (`repro_torch.resilience`): every backend call of the workers
goes through `_with_retry`, which classifies failures
(`repro_torch.io.backend.classify_io_error`), rides out transient ones
with bounded backoff (`store_retries` / `load_retries`, the
`resilience.retry` counter and instant) and feeds the spool's
`BackendHealth`, which `AdaptivePolicy` re-plans from. A cache-manager
backend gets the spool's tensor classes declared and its reuse-distance
hints fed from `prefetch`.

Blobs are RSA2 serde (`repro_torch.io.serde`) inside the codec container,
so the JAX package can read them and the port can read the JAX
package's.

Tracing (`repro_torch.obs`) uses the JAX package's names: the
`spool.offload` instant and `spool.store_backlog` gauge, the
`prefetch.issued` / `.hit` / `.late` / `.ghost` counters, and the
`spool.fetch_wait`, `spool.store` (with `codec.encode` inside) and
`spool.load` (with `codec.decode` inside) spans, each keyed by the
backend key `str(key)`. The pinned copy of a decoded payload runs inside
`spool.load` but outside `io.read` and `codec.decode`; the copy back to
the card runs on the caller's thread, after the wait, outside every I/O
span.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.core.accounting import MemoryTracker
from repro_torch.core.adaptive import TierBandwidth
from repro_torch.core.ids import TensorIdRegistry, tensor_key
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.io.backend import StorageBackend, classify_io_error
from repro_torch.io.bufpool import DEFAULT_ALIGNMENT, AlignedBufferPool
from repro_torch.io.codecs import (Codec, RawCodec, encode_parts,
                                   get_codec, pack_parts, unpack_aliased)
from repro_torch.io.factory import build_backend
from repro_torch.io.serde import (deserialize_leaves, header_parts,
                                  serialize_parts)
from repro_torch.obs.overlap import (DECODE_SPAN, ENCODE_SPAN,
                                     FETCH_WAIT_SPAN, LOAD_SPAN, STORE_SPAN)
from repro_torch.resilience.health import BackendHealth
from repro_torch.resilience.retry import RetryPolicy

# job states
QUEUED, RUNNING, DONE, CANCELED = range(4)

# paper Algorithm 2 line 12: tensors smaller than 2**20 elements stay put
MIN_OFFLOAD_ELEMENTS = 2 ** 20


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _dense_stride(t):
    """t's strides if they cover exactly numel elements (a contiguous or
    permuted layout, which a reload restores so backward kernels see the
    same layout), else None: a view with gaps comes back contiguous,
    rather than allocating its whole base's extent."""
    if t.is_contiguous():
        return None
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())
                     if n > 0)
    return t.stride() if extent == t.numel() else None


def _with_stride(h, stride, device=None):
    """An empty tensor like h (on `device`) with `stride` when given."""
    device = device or h.device
    if stride is None:
        return torch.empty(h.shape, dtype=h.dtype, device=device)
    return torch.empty_strided(h.shape, stride, dtype=h.dtype,
                               device=device)


# ------------------------------------------------------------- config

def build_spool(io_cfg, *, min_offload_elements: int = MIN_OFFLOAD_ELEMENTS,
                tracker: Optional[MemoryTracker] = None,
                cuda: bool = False) -> "ActivationSpool":
    """A spool over the storage stack a SpoolIoConfig selects (backend,
    codec, threads, pool, retry, bandwidth limit; `pool_bytes` caps the
    shared pool, an aio backend's own included); temp dirs the factory
    creates are removed by `spool.close()`. `cuda`: the session runs on
    the card, so the pool registers its buffers with CUDA. Serving
    passes min_offload_elements=0: KV pages are small and must reach
    storage."""
    io_cfg.validate()
    backend = build_backend(io_cfg)
    if getattr(backend, "pool", None) is not None:
        # a backend with a pool of its own (aio) shares it with the
        # spool; a spec string cannot carry the cap, so set it here
        backend.pool.max_bytes = io_cfg.pool_bytes
    return ActivationSpool(
        backend, codec=io_cfg.codec, store_threads=io_cfg.store_threads,
        load_threads=io_cfg.load_threads,
        bandwidth_limit=io_cfg.bandwidth_limit,
        min_offload_elements=min_offload_elements, tracker=tracker,
        pool_bytes=io_cfg.pool_bytes, alignment=io_cfg.alignment,
        retry=RetryPolicy(max_attempts=io_cfg.retry_attempts,
                          backoff_s=io_cfg.retry_backoff_s,
                          backoff_max_s=io_cfg.retry_backoff_max_s),
        owned_dirs=getattr(backend, "owned_tmpdirs", ()), cuda=cuda)


@dataclass
class SpoolStats:
    bytes_offloaded: int = 0            # encoded bytes written
    # pre-codec bytes behind bytes_offloaded: their ratio is the codec's
    # measured compression on real activations
    bytes_offloaded_logical: int = 0
    bytes_loaded: int = 0
    bytes_forwarded: int = 0
    bytes_deduped: int = 0
    stores_canceled: int = 0
    store_time: float = 0.0
    load_time: float = 0.0
    num_stores: int = 0
    num_loads: int = 0
    # time the consumer spent blocked waiting for a load: the I/O
    # latency exposed on the critical path
    fetch_wait_time: float = 0.0
    # resilience: transient failures the workers rode out, and fetches
    # the engine degraded to recompute after a lost blob
    store_retries: int = 0
    load_retries: int = 0
    fetch_fallbacks: int = 0
    # optimizer-moment bytes the overlap bridge did not rewrite because
    # they were unchanged (its write-back policy)
    opt_skipped_bytes: int = 0

    @property
    def write_bandwidth(self) -> float:
        return (self.bytes_offloaded / self.store_time
                if self.store_time else 0.0)

    def snapshot(self) -> "SpoolStats":
        """Value copy of the live (mutating) stats."""
        return dataclasses.replace(self)

    def sub(self, other: "SpoolStats") -> "SpoolStats":
        """Field-wise difference: two cumulative snapshots -> a per-step
        delta (`new.sub(old)`)."""
        return SpoolStats(**{f.name: getattr(self, f.name)
                             - getattr(other, f.name)
                             for f in dataclasses.fields(SpoolStats)})


class _Job:
    __slots__ = ("key", "arrays", "state", "cond", "kind", "orphaned",
                 "error", "event", "reg_keys", "prefetched", "lease",
                 "blob", "forwarded", "h2d_done")

    def __init__(self, key, arrays, kind, event=None):
        self.key = key
        self.arrays = arrays      # host tensors (pool views for CUDA)
        self.state = QUEUED
        self.cond = threading.Condition()
        self.kind = kind          # "store" | "load"
        self.orphaned = False     # dropped while the store was running
        self.error = None         # exception raised by the worker
        self.event = event        # the device-to-host copy's CUDA event
        # (key, tid) registry entries of the spooled leaves, released by
        # the store worker when the write lands, or by drop()
        self.reg_keys: tuple = ()
        # a load issued by prefetch(), ahead of its fetch (not on demand)
        self.prefetched = False
        # a CUDA record's host copy: the pool lease it lives in, the
        # whole raw blob as one view of it, whether a copy back to the
        # card read it (forwarding) and that copy's event
        self.lease = None
        self.blob = None
        self.forwarded = False
        self.h2d_done = None


class SpoolLoadError(RuntimeError):
    """A record's blob could not be read back (lost, truncated, or the
    backend failed): the engine's cue to recompute the stage instead."""


class SpoolStepTransaction:
    """Transactional lease on a set of spool records. Stages are
    addressed by index and keyed ``{lease_id}_s{stage}``; `close` drops
    every record not consumed yet, so an aborted user never strands
    blobs on the backend. The training engine opens one lease per
    microbatch (``mb{mb}``), the mesh hooks one per step and shard
    (``jit{step}/s{shard}``, `core/hooks.py`); the paged KV cache one per
    served sequence, with logical page indices as stages.

    A stage recorded with ``consumers=n`` (the JAX package's countdown,
    `repro/core/spool.py:205-372`; a record one replica stores for n
    shards) is read by n `consume` calls: the first n-1 peek, without
    cancelling a store still queued, and the last fetches and drops it.
    `release` counts a consumer down without reading (a consumer in
    another process that read the blob itself)."""

    __slots__ = ("_spool", "step_id", "_live", "_closed", "_tlock",
                 "_consumers", "_stage_locks")

    def __init__(self, spool: "ActivationSpool", step_id: str):
        self._spool = spool
        self.step_id = step_id
        self._live: Dict[Any, str] = {}     # stage -> spool key
        # stage -> consume() calls left before the stage is dropped
        self._consumers: Dict[Any, int] = {}
        # stage -> lock serialising the consumers of one stage, so a
        # peek never races the last consumer's drop (which releases the
        # pooled buffer the peek's views borrow)
        self._stage_locks: Dict[Any, threading.Lock] = {}
        self._closed = False
        self._tlock = threading.Lock()

    def key(self, stage) -> str:
        return f"{self.step_id}_s{stage}"

    def _record(self, stage, consumers: int = 1) -> str:
        if consumers < 1:
            raise ValueError(f"consumers must be >= 1, got {consumers}")
        with self._tlock:
            if self._closed:
                raise RuntimeError(
                    f"spool lease {self.step_id!r} is closed")
            if stage in self._live:
                raise KeyError(f"stage {stage!r} already live in lease "
                               f"{self.step_id!r}")
            key = self._live[stage] = self.key(stage)
            self._consumers[stage] = consumers
            self._stage_locks[stage] = threading.Lock()
        return key

    def offload(self, stage, tree, *, consumers: int = 1) -> None:
        """Async-store a stage's tree under this lease; `consumers` is
        how many `consume` calls it expects."""
        self._spool.offload(self._record(stage, consumers), tree)

    def offload_staged(self, stage, host, lease, blob=None,
                       device=None) -> None:
        """Async-store host leaves already laid out in a pool lease
        (`ActivationSpool.offload_staged`) under this lease."""
        self._spool.offload_staged(self._record(stage), host, lease, blob,
                                   device)

    def keep(self, stage, tree, *, consumers: int = 1) -> None:
        """Record a stage's tree as kept in memory under this lease."""
        self._spool.keep(self._record(stage, consumers), tree)

    def adopt(self, stage, tree) -> None:
        """Record a stage whose blob another process stores under the
        same key in a shared directory: `tree` (this process's identical
        copy) gives the layout and the leaves kept in memory; the rest is
        read back from that blob, which this lease never writes or
        deletes (`ActivationSpool.adopt`)."""
        self._spool.adopt(self._record(stage), tree)

    def has_stage(self, stage) -> bool:
        with self._tlock:
            return stage in self._live

    def _key(self, stage) -> str:
        with self._tlock:
            key = self._live.get(stage)
        if key is None:
            raise KeyError(f"stage {stage!r} not recorded in lease "
                           f"{self.step_id!r}")
        return key

    def prefetch(self, stage) -> None:
        """Hint an async load; an unknown stage is ignored."""
        with self._tlock:
            key = self._live.get(stage)
        if key is not None:
            self._spool.prefetch(key)

    def fetch(self, stage, *, to_device: bool = True):
        """Blocking: the stage's tree (forwarded or reloaded).
        `to_device=False` leaves reloaded leaves on the host, in their
        pooled lease (valid until the record is dropped)."""
        return self._spool.fetch(self._key(stage), to_device=to_device)

    def peek(self, stage, *, to_device: bool = True):
        """Non-consuming fetch: the tree, without cancelling a store
        still queued, so a later fetch or peek finds the blob (the
        optimizer overlap's moments, checkpoints of a staged-out
        optimizer state)."""
        return self._spool.fetch(self._key(stage), cancel_pending=False,
                                 to_device=to_device)

    def _stage_lock(self, stage) -> threading.Lock:
        with self._tlock:
            if stage not in self._live:
                raise KeyError(f"stage {stage!r} not recorded in lease "
                               f"{self.step_id!r}")
            return self._stage_locks[stage]

    def consume(self, stage, *, to_device: bool = True):
        """Fetch the stage's tree and count one consumer down; the last
        consumer's call also drops the record (memory + blob)."""
        slock = self._stage_lock(stage)
        with slock:
            last = self._take(stage)
            if last:
                out = self.fetch(stage, to_device=to_device)
                self.drop(stage)
            else:
                # a peek that leaves no device copy with the record: the
                # stage may wait for other consumers until its lease ends
                out = self._spool.fetch(self._key(stage),
                                        cancel_pending=False,
                                        to_device=to_device, cache=False)
        return out

    def release(self, stage) -> None:
        """Count one consumer down without reading; the last one drops
        the record."""
        slock = self._stage_lock(stage)
        with slock:
            if self._take(stage):
                self.drop(stage)

    def _take(self, stage) -> bool:
        """One consumer of `stage` less; True for the last."""
        with self._tlock:
            remaining = self._consumers.get(stage, 0)
            if remaining <= 0:
                raise KeyError(f"stage {stage!r} already consumed in "
                               f"lease {self.step_id!r}")
            self._consumers[stage] = remaining - 1
            return remaining == 1

    def consumers_left(self, stage) -> int:
        with self._tlock:
            return self._consumers.get(stage, 0)

    def drop(self, stage) -> None:
        with self._tlock:
            key = self._live.pop(stage, None)
            self._consumers.pop(stage, None)
            self._stage_locks.pop(stage, None)
        if key is not None:
            self._spool.drop(key)

    @property
    def live_stages(self):
        with self._tlock:
            return sorted(self._live)

    def close(self) -> None:
        """Drop every record not consumed yet and release the lease.
        Idempotent."""
        with self._tlock:
            if self._closed:
                return
            self._closed = True
            leftover = list(self._live)
        for stage in leftover:
            self.drop(stage)
        self._spool._release_lease(self.step_id)

    def __enter__(self) -> "SpoolStepTransaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class ActivationSpool:
    def __init__(self, backend: StorageBackend, *,
                 store_threads: int = 4, load_threads: int = 4,
                 codec: Union[str, Codec, None] = None,
                 bandwidth_limit: Optional[float] = None,
                 min_offload_elements: int = MIN_OFFLOAD_ELEMENTS,
                 tracker: Optional[MemoryTracker] = None,
                 registry: Optional[TensorIdRegistry] = None,
                 pool: Optional[AlignedBufferPool] = None,
                 pool_bytes: int = 256 << 20,
                 alignment: int = DEFAULT_ALIGNMENT,
                 retry: Optional[RetryPolicy] = None,
                 health: Optional[BackendHealth] = None,
                 owned_dirs: Tuple[str, ...] = (),
                 cuda: bool = False):
        self.backend = backend
        # a cache-manager backend (duck-typed on hint_next) gets the
        # spool's tensor classes declared up front and its reuse hints
        # fed from prefetch
        self.cache_manager = backend if hasattr(backend, "hint_next") \
            else None
        if self.cache_manager is not None:
            self.cache_manager.register_class("activation")
            self.cache_manager.register_class("opt_state", prefix="opt")
        self.codec = get_codec(codec)
        # one aligned pool serves the whole data plane: stores copy into
        # leases, loads readinto them, and an aio backend stages from it
        backend_pool = getattr(backend, "pool", None)
        self.pool = pool or backend_pool or AlignedBufferPool(
            alignment=alignment, max_bytes=pool_bytes)
        self._owns_pool = pool is None and backend_pool is None
        if cuda:
            self.pool.register_cuda()
        self.min_offload_elements = min_offload_elements
        self.tracker = tracker or MemoryTracker()
        self.registry = registry or TensorIdRegistry()
        self.stats = SpoolStats()
        self.retry = retry or RetryPolicy()
        self.retry.validate()
        self.health = health or BackendHealth(self.backend.kind)
        if self.cache_manager is not None:
            # SSD-tier write failures inside the manager surface as
            # health events next to the spool's retries
            self.cache_manager.attach_health(self.health)
        self._bw = bandwidth_limit
        self._owned_dirs = list(owned_dirs)
        self._lock = threading.Lock()
        self._records: Dict[Any, Dict] = {}
        # the store job writing each key: keys recur every step, and a
        # dropped record's store may still be writing when the next
        # step's store of its key starts
        self._writing: Dict[Any, _Job] = {}
        # leases whose records are gone but whose copy back to the card
        # may still be reading them: (event, lease)
        self._draining: List[Tuple[Any, Any]] = []
        self._leases: set = set()
        self._streams: Dict[Tuple[str, str], Any] = {}   # side streams
        self._store_q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._load_q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._closed = False
        self._n_threads = {"store": store_threads, "load": load_threads}
        self._threads: List[threading.Thread] = []
        self._codec_bw = float("inf")
        self._codec_ratio = 1.0
        # replica dedup across processes (`core/hooks.py`): called with a
        # key once its store has landed, and by a load of an adopted
        # record before it reads (blocking until its writer's store has)
        self.on_landed = None
        self.remote_wait = None
        for name, q, n in (("store", self._store_q, store_threads),
                           ("load", self._load_q, load_threads)):
            for i in range(n):
                t = threading.Thread(target=self._worker, args=(q,),
                                     daemon=True, name=f"spool-{name}-{i}")
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------------- API

    def lease(self, lease_id) -> SpoolStepTransaction:
        """Open a transactional lease; at most one live lease per id."""
        if self._closed:
            raise RuntimeError("spool is closed")
        lease_id = str(lease_id)
        with self._lock:
            if lease_id in self._leases:
                raise RuntimeError(f"lease {lease_id!r} is already active")
            self._leases.add(lease_id)
        return SpoolStepTransaction(self, lease_id)

    step = lease        # the training engine's name for a step lease

    def _release_lease(self, lease_id: str) -> None:
        with self._lock:
            self._leases.discard(lease_id)

    def register_parameters(self, params) -> int:
        """Exclude every view of the parameters' storages from offload."""
        return self.registry.register_parameters(params)

    def _stream(self, device, role: str):
        k = (str(device), role)
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(device=device)
        return self._streams[k]

    # ------------------------------------------------------ pool leases

    def _release_after(self, lease, event) -> None:
        """Give `lease` back to the pool once `event` (a copy back to the
        card that reads it) has completed: now if it has."""
        if lease is None:
            return
        if event is None or event.query():
            lease.release()
            return
        with self._lock:
            self._draining.append((event, lease))

    def _reap(self, wait: bool = False) -> None:
        """Release the draining leases whose copies have run (all of
        them, after waiting, with `wait`)."""
        with self._lock:
            if not self._draining:
                return
            pending, self._draining = self._draining, []
        keep = []
        for event, lease in pending:
            if wait:
                event.synchronize()
            if wait or event.query():
                lease.release()
            else:
                keep.append((event, lease))
        if keep:
            with self._lock:
                self._draining.extend(keep)

    def host_layout(self, like) -> Tuple[List[torch.Tensor], Any,
                                         Optional[memoryview]]:
        """One pool lease laid out as the blob of tensors shaped like
        `like` (with the raw codec the container and serde headers come
        first and each leaf's bytes follow, so the blob is one contiguous
        view of the lease): (a host tensor over each leaf's slot, the
        lease, the whole raw blob or None)."""
        raw = isinstance(self.codec, RawCodec)
        head = (b"".join(bytes(p) for p in encode_parts(
            header_parts(like), self.codec)) if raw else b"")
        sizes = [t.numel() * t.element_size() for t in like]
        total = len(head) + sum(sizes)
        self._reap()
        lease = self.pool.acquire(total)
        mv = lease.mv
        mv[:len(head)] = head
        host, off = [], len(head)
        for t, n in zip(like, sizes):
            host.append(torch.frombuffer(mv[off:off + n], dtype=t.dtype)
                        .view(t.shape) if n else
                        torch.empty(t.shape, dtype=t.dtype))
            off += n
        return host, lease, (mv[:total] if raw else None)

    def _to_host(self, leaves):
        """Host copies of the leaves to spool: (tensors, the device-to-host
        copy's event, their pool lease, the whole raw blob). CPU leaves
        are held by reference. CUDA leaves are copied on a side stream
        into one pool lease laid out as the blob (`host_layout`)."""
        dev = next((t.device for t in leaves if t.is_cuda), None)
        if dev is None:
            return list(leaves), None, None, None
        host, lease, blob = self.host_layout(leaves)
        stream = self._stream(dev, "d2h")
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for h, t in zip(host, leaves):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)     # freed only after the copy
        event = torch.cuda.Event()
        event.record(stream)
        return host, event, lease, blob

    def offload(self, key, tree) -> None:
        """Async-store a tree of tensors under `key`. Parameters, leaves
        smaller than
        `min_offload_elements` and duplicates of live tracked tensors
        stay in memory (recorded, not written)."""
        leaves, treedef = tree_flatten(tree)
        keep_idx, spool_idx, acquired, spooled_keys = [], [], [], []
        kept_bytes = alias_bytes = 0
        for i, leaf in enumerate(leaves):
            if self.registry.is_parameter(leaf):
                keep_idx.append(i)
                continue
            nb = leaf.numel() * leaf.element_size()
            if leaf.numel() < self.min_offload_elements:
                keep_idx.append(i)
                kept_bytes += nb
                continue
            tid, dup = self.registry.acquire(leaf)
            if dup:
                # alias of a live tracked tensor: keep the reference,
                # never write it twice
                acquired.append((tensor_key(leaf), tid))
                keep_idx.append(i)
                alias_bytes += nb
            else:
                spooled_keys.append((tensor_key(leaf), tid))
                spool_idx.append(i)
        self.stats.bytes_deduped += alias_bytes
        spooled = [leaves[i] for i in spool_idx]
        strides = [_dense_stride(t) for t in spooled]
        device = spooled[0].device if spooled else None
        nbytes = _nbytes(spooled)
        if kept_bytes:
            self.tracker.alloc((key, "k"), kept_bytes,
                               tag=f"kept_small:{key}")
        job = None
        if spooled:
            host, event, lease, blob = self._to_host(spooled)
            job = _Job(key, host, "store", event)
            job.lease, job.blob = lease, blob
            job.reg_keys = tuple(spooled_keys)
        self._add_store(key, treedef, {i: leaves[i] for i in keep_idx},
                        spool_idx, len(leaves), job, nbytes, device,
                        strides, acquired)

    def offload_staged(self, key, host, lease, blob=None,
                       device=None) -> None:
        """Async-store host leaves that the caller has already written
        into a lease laid out by `host_layout` (the optimizer overlap
        copies each moment there as it is computed). Every leaf is
        written and the spool owns the lease from here. `device` is
        where `fetch(to_device=True)` returns the leaves (None: the
        host)."""
        job = _Job(key, list(host), "store")
        job.lease, job.blob = lease, blob
        self._add_store(key, tree_flatten(list(host))[1], {},
                        list(range(len(host))), len(host), job,
                        _nbytes(host), device, [None] * len(host), [])

    def _add_store(self, key, treedef, keep, spool_idx, n_leaves, job,
                   nbytes, device, strides, acquired) -> None:
        if job is not None:
            self.tracker.alloc((key, "s"), nbytes, tag=f"residual:{key}")
        with self._lock:
            if key in self._records:
                raise KeyError(f"spool key {key!r} is already live")
            self._records[key] = {
                "treedef": treedef, "keep": keep,
                "spool_idx": spool_idx, "n_leaves": n_leaves,
                "job": job, "nbytes": nbytes, "loaded": None,
                "load_job": None, "load_lease": None,
                "fwd_counted": False, "device": device,
                "strides": strides, "on_device": None,
                "acquired": acquired, "load_used": False}
        if job is not None:
            self._store_q.put(job)
            if obs.is_enabled():
                obs.instant("spool.offload", cat="spool", key=str(key),
                            bytes=nbytes)
                obs.gauge("spool.store_backlog", self._store_q.qsize())

    def keep(self, key, tree) -> None:
        """Record a tree kept where it is (never written)."""
        leaves, treedef = tree_flatten(tree)
        acts = [t for t in leaves if not self.registry.is_parameter(t)]
        acquired = [(tensor_key(t), self.registry.acquire(t)[0])
                    for t in acts]
        nbytes = _nbytes(acts)
        self.tracker.alloc((key, "k"), nbytes, tag=f"kept:{key}")
        with self._lock:
            if key in self._records:
                raise KeyError(f"spool key {key!r} is already live")
            self._records[key] = {
                "treedef": treedef, "keep": dict(enumerate(leaves)),
                "spool_idx": [], "n_leaves": len(leaves), "job": None,
                "nbytes": nbytes, "loaded": None, "load_job": None,
                "load_lease": None, "fwd_counted": False, "device": None,
                "strides": [], "on_device": None, "acquired": acquired,
                "load_used": False}

    def adopt(self, key, tree) -> None:
        """Record `key` as a blob another process writes: the replica
        dedup of a mesh (`core/hooks.py`), where the primary replica
        stores one copy in a directory every rank sees. `tree` is this
        process's identical copy: its leaves that `offload` would keep
        (parameters, small and duplicate leaves) stay, the rest are read
        back from the blob, which must hold them in order. A load of it
        first waits on `remote_wait(key)` (the store landed); `drop` never
        deletes the blob, which its writer owns."""
        leaves, treedef = tree_flatten(tree)
        keep_idx, spool_idx, acquired = [], [], []
        kept_bytes = 0
        for i, leaf in enumerate(leaves):
            if self.registry.is_parameter(leaf):
                keep_idx.append(i)
                continue
            if leaf.numel() < self.min_offload_elements:
                keep_idx.append(i)
                kept_bytes += leaf.numel() * leaf.element_size()
                continue
            tid, dup = self.registry.acquire(leaf)
            acquired.append((tensor_key(leaf), tid))
            (keep_idx if dup else spool_idx).append(i)
        spooled = [leaves[i] for i in spool_idx]
        if kept_bytes:
            self.tracker.alloc((key, "k"), kept_bytes,
                               tag=f"kept_small:{key}")
        job = None
        if spooled:
            job = _Job(key, None, "store")
            job.state = DONE           # written elsewhere: never here
        with self._lock:
            if key in self._records:
                raise KeyError(f"spool key {key!r} is already live")
            self._records[key] = {
                "treedef": treedef, "keep": {i: leaves[i] for i in keep_idx},
                "spool_idx": spool_idx, "n_leaves": len(leaves),
                "job": job, "nbytes": _nbytes(spooled), "loaded": None,
                "load_job": None, "load_lease": None, "fwd_counted": False,
                "device": spooled[0].device if spooled else None,
                "strides": [_dense_stride(t) for t in spooled],
                "on_device": None, "acquired": acquired,
                "load_used": False, "remote": True,
                "shapes": [tuple(t.shape) for t in spooled]}

    @staticmethod
    def _on_cuda(rec) -> bool:
        return rec["device"] is not None and rec["device"].type == "cuda"

    def _start_h2d(self, rec, host, event):
        """Copy a CUDA record's host data back to its device, with its
        saved strides, on a side stream (after the device-to-host copy's
        event when the data is forwarded)."""
        dev = rec["device"]
        stream = self._stream(dev, "h2d")
        if event is not None:
            stream.wait_event(event)
        with torch.cuda.stream(stream):
            out = []
            for h, stride in zip(host, rec["strides"]):
                out.append(_with_stride(h, stride, dev).copy_(
                    h, non_blocking=True))
        done = torch.cuda.Event()
        done.record(stream)
        rec["on_device"] = (out, done)
        with rec["job"].cond:
            rec["job"].h2d_done = done

    def prefetch(self, key, *, _demand: bool = False) -> None:
        """Hint an async load of `key`; a record still in memory is left
        to fetch, which forwards it (so a record's device copy is made
        at its fetch, never earlier: the device footprint does not
        depend on when stores land). `_demand`: issued by fetch()
        itself, so not counted as a prefetch."""
        if self.cache_manager is not None:
            # the reuse horizon doubles as the placement hint: protect
            # the blob from eviction and promote it off SSD ahead of the
            # load worker's read
            self.cache_manager.hint_next([str(key)])
        with self._lock:
            rec = self._records.get(key)
            if rec is None or rec["job"] is None:
                return
        with rec["job"].cond:
            if rec["job"].arrays is not None:
                return      # still in memory: fetch forwards it
        with self._lock:
            if rec["load_job"] is not None or rec["loaded"] is not None:
                return
            lj = rec["load_job"] = _Job(key, None, "load")
            lj.prefetched = not _demand
        if not _demand:
            obs.count("prefetch.issued")
            obs.instant("spool.prefetch", cat="spool", key=str(key))
        self._load_q.put(lj)

    def fetch(self, key, *, cancel_pending: bool = True,
              to_device: bool = True, cache: bool = True):
        """Blocking: the full tree of `key`. Leaves of a record that came
        from the card are returned on it. Raises `SpoolLoadError` when
        the blob cannot be read back.

        `cancel_pending=False` is the non-consuming peek: a store still
        queued is forwarded but not cancelled, so its blob still lands
        for a later fetch. `to_device=False` returns the host leaves as
        they are, with no copy: a forwarded record's host copy (its
        device-to-host copy waited for) or a reloaded one's views over
        its pooled lease, valid until the record is dropped. `cache=False`
        leaves the record no device copy of what it returns."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                raise KeyError(key)
        job = rec["job"]
        spooled, event, forwarded = None, None, False
        if job is not None:
            with job.cond:
                if job.arrays is not None:
                    forwarded = job.forwarded = True
                    # tensor forwarding (§3.3.2): the store is queued, in
                    # flight, cancelled or failed — its host copy is
                    # still here, so hand it over instead of reading
                    spooled, event = job.arrays, job.event
                    if not rec["fwd_counted"]:
                        rec["fwd_counted"] = True
                        self.stats.bytes_forwarded += rec["nbytes"]
                    if job.state == QUEUED and cancel_pending:
                        job.state = CANCELED
                        self.stats.stores_canceled += 1
            if spooled is None:
                with self._lock:
                    lj = rec["load_job"]
                if lj is None:
                    self.prefetch(key, _demand=True)
                    with self._lock:
                        lj = rec["load_job"]
                if lj is not None:
                    if lj.prefetched:
                        # hit: the prefetched load landed before the
                        # consumer came; late: it is still under way
                        with lj.cond:
                            ready = lj.state in (DONE, CANCELED)
                        obs.count("prefetch.hit" if ready
                                  else "prefetch.late")
                    t0 = time.perf_counter()
                    with obs.span(FETCH_WAIT_SPAN, cat="spool",
                                  key=str(key)):
                        with lj.cond:
                            while lj.state not in (DONE, CANCELED):
                                lj.cond.wait()
                    self.stats.fetch_wait_time += time.perf_counter() - t0
                    if lj.error is not None:
                        raise SpoolLoadError(
                            f"spool load failed for {key!r}") from lj.error
                with self._lock:
                    spooled = rec["loaded"]
                    rec["load_used"] = True
                self.tracker.alloc((key, "s"), rec["nbytes"],
                                   tag=f"reloaded:{key}")
        leaves = [None] * rec["n_leaves"]
        for i, leaf in rec["keep"].items():
            leaves[i] = leaf
        if rec.get("remote") and spooled is not None and (
                len(spooled) != len(rec["spool_idx"])
                or [tuple(h.shape) for h in spooled]
                != rec["shapes"]):
            raise SpoolLoadError(f"the blob of {key!r} does not hold the "
                                 f"leaves this process recorded")
        if rec["spool_idx"]:
            if to_device:
                spooled = self._materialize(rec, spooled, event, forwarded,
                                            cache)
            elif event is not None:
                event.synchronize()     # the device-to-host copy landed
            for i, leaf in zip(rec["spool_idx"], spooled):
                leaves[i] = leaf
        return tree_unflatten(rec["treedef"], leaves)

    def _materialize(self, rec, host, event, forwarded, cache=True):
        if self._on_cuda(rec):
            if rec["on_device"] is None or rec["on_device"][0] is None:
                self._start_h2d(rec, host, event)
            out, done = rec["on_device"]
            cur = torch.cuda.current_stream(rec["device"])
            cur.wait_event(done)
            for t in out:
                t.record_stream(cur)
            if not cache:
                # the event stays: drop releases the lease after the copy
                rec["on_device"] = (None, done)
            return out
        if forwarded:
            return host
        if rec["load_lease"] is not None:
            # views over a pool lease that the next load reuses: they
            # would become the graph's saved tensors, so copy them once
            return [_with_stride(h, stride).copy_(h)
                    for h, stride in zip(host, rec["strides"])]
        # reloaded leaves come back contiguous: restore permuted layouts
        return [h if stride is None else _with_stride(h, stride).copy_(h)
                for h, stride in zip(host, rec["strides"])]

    def drop(self, key) -> None:
        """Consume a record: free its memory and delete its blob."""
        with self._lock:
            rec = self._records.pop(key, None)
        if rec is None:
            return
        lj = rec["load_job"]
        if lj is not None and lj.prefetched and not rec["load_used"]:
            # ghost: prefetched from the backend but dropped unread
            obs.count("prefetch.ghost")
        for bkey, tid in rec["acquired"]:
            self.registry.release_key(bkey, tid)
        self.tracker.free((key, "s"), tag=f"consumed:{key}")
        self.tracker.free((key, "k"), tag=f"consumed:{key}")
        done = rec["on_device"][1] if rec["on_device"] else None
        rec["loaded"] = rec["on_device"] = None
        self._release_after(rec.pop("load_lease"), done)
        self._reap()
        job = rec["job"]
        if job is None or rec.get("remote"):
            return
        lease = None
        with job.cond:
            keys, job.reg_keys = job.reg_keys, ()
            state = job.state
            # a store never written may still have its device-to-host
            # copy running into the lease; a copy back to the card
            # (`done`) was queued after that copy, so it covers both
            done = done or job.event
            if state == QUEUED:
                # never written: the worker skips the cancelled write
                job.state = CANCELED
                self.stats.stores_canceled += 1
            elif state == RUNNING:
                # the write lands after this drop: the worker deletes it
                # and gives its lease back
                job.orphaned = True
            if state != RUNNING:
                job.arrays = job.blob = None   # free a cancelled copy
                lease, job.lease = job.lease, None
        self._release_after(lease, done)
        for bkey, tid in keys:
            self.registry.release_key(bkey, tid)
        if state not in (QUEUED, RUNNING):
            self.backend.delete(str(key))

    def live_keys(self) -> List:
        with self._lock:
            return list(self._records)

    def wait_io(self) -> None:
        """Barrier: wait for every queued store and load."""
        self._store_q.join()
        self._load_q.join()

    # ---------------------------------------------------- planner input

    def calibrate_backend(self, nbytes: int, repeats: int = 2) -> None:
        """Re-measure the store path with an uncontended burst of
        `nbytes` (call after wait_io): the codec's encode rate and size
        ratio (from the real spooled residuals when there are any), and
        every tier's write rate through `backend.calibrate`."""
        if nbytes <= 0:
            return
        payload = os.urandom(nbytes)
        t0 = time.perf_counter()
        for _ in range(repeats):
            data = pack_parts([payload], self.codec)
        t_codec = (time.perf_counter() - t0) / repeats
        self._codec_bw = nbytes / t_codec if t_codec > 0 else float("inf")
        st = self.stats
        self._codec_ratio = (st.bytes_offloaded / st.bytes_offloaded_logical
                             if st.bytes_offloaded_logical
                             else len(data) / nbytes)
        self.backend.calibrate(data, repeats)

    def planner_bandwidth(self) -> Union[float, List[TierBandwidth]]:
        """What the adaptive planner plans against: each tier's store-path
        rate in logical residual bytes per second (the measured device
        rate composed harmonically with the codec's rate: the worker
        encodes, then writes), with capacities in logical bytes; the
        spool's own busy-clock scalar while a tier is unmeasured."""
        tiers = self.backend.tier_bandwidths()
        if not tiers or any(t.write_bw <= 0 or t.write_bw == float("inf")
                            for t in tiers):
            return self.stats.write_bandwidth
        ratio = self._codec_ratio
        out = []
        for t in tiers:
            per_byte = ratio / t.write_bw + (1.0 / self._codec_bw
                                             if self._codec_bw > 0 else 0.0)
            bw = 1.0 / per_byte
            if self._bw:
                bw = min(bw, self._bw / max(ratio, 1e-9))
            cap = (None if t.capacity_bytes is None
                   else int(t.capacity_bytes / max(ratio, 1e-9)))
            out.append(TierBandwidth(t.name, bw, cap))
        return out

    def data_plane_stats(self) -> Dict[str, Any]:
        """The whole byte path in one dict: the backend's I/O (with host
        copies per byte) and the aligned pool's reuse."""
        return {"backend": self.backend.stats.as_dict(),
                "pool": self.pool.stats()}

    def close(self) -> None:
        """Drain queued I/O, stop and join the workers, give back every
        pool lease, close the backend (and the pool, if the spool made
        it) and remove the temp dirs the spool owns. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.wait_io()
        for _ in range(self._n_threads["store"]):
            self._store_q.put(None)
        for _ in range(self._n_threads["load"]):
            self._load_q.put(None)
        for t in self._threads:
            t.join()
        self._threads = []
        self._reap(wait=True)
        self.backend.close()
        if self._owns_pool:
            self.pool.close()
        for d in self._owned_dirs:
            shutil.rmtree(d, ignore_errors=True)

    # --------------------------------------------------------- workers

    def _with_retry(self, op: str, key, fn):
        """One backend call with bounded retry and backoff on transient
        failures; every outcome feeds the health monitor."""
        attempt = 1
        while True:
            t0 = time.perf_counter()
            try:
                out = fn()
            except BaseException as e:
                self.health.record_failure(op, e, time.perf_counter() - t0)
                if (classify_io_error(e) != "transient"
                        or attempt >= self.retry.max_attempts):
                    raise
                if op == "write":
                    self.stats.store_retries += 1
                else:
                    self.stats.load_retries += 1
                if obs.is_enabled():
                    obs.count("resilience.retry")
                    obs.instant("resilience.retry", cat="resilience",
                                op=op, key=str(key), attempt=attempt,
                                error=repr(e))
                time.sleep(self.retry.delay(attempt))
                attempt += 1
            else:
                self.health.record_success(op, time.perf_counter() - t0)
                return out

    def _throttle(self, nbytes: int, t0: float) -> float:
        """Seconds since t0, stretched to nbytes / bandwidth_limit."""
        dt = time.perf_counter() - t0
        if self._bw and dt < nbytes / self._bw:
            time.sleep(nbytes / self._bw - dt)
            dt = nbytes / self._bw
        return dt

    def _worker(self, q: "queue.Queue[Optional[_Job]]") -> None:
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            try:
                if job.kind == "store":
                    self._store(job)
                else:
                    self._load(job)
            except Exception as e:   # surfaced at fetch(), never lost
                job.error = e
                with job.cond:
                    job.state = DONE
                    job.cond.notify_all()
            finally:
                q.task_done()

    def _store(self, job: _Job) -> None:
        # a store starts and registers in one step: a record dropped
        # after this point has its store registered before any newer
        # store of its key can register
        with self._lock:
            with job.cond:
                if job.state == CANCELED:
                    job.cond.notify_all()
                    return
                job.state = RUNNING
            prev = self._writing.get(job.key)
            self._writing[job.key] = job
        try:
            if prev is not None:
                # an earlier store of this key (its record dropped while
                # it was writing) lands first, so the blob left under
                # the key is this newer one
                with prev.cond:
                    while prev.state == RUNNING:
                        prev.cond.wait()
            self._write_blob(job)
        finally:
            with self._lock:
                if self._writing.get(job.key) is job:
                    del self._writing[job.key]

    def _write_blob(self, job: _Job) -> None:
        t0 = time.perf_counter()
        key = str(job.key)
        arrays = job.arrays
        with obs.span(STORE_SPAN, cat="spool", key=key) as store_sp:
            if job.event is not None:
                job.event.synchronize()     # the device-to-host copy landed
            with obs.span(ENCODE_SPAN, cat="codec", key=key):
                # a raw blob laid out in its lease is written as is
                parts = ([job.blob] if job.blob is not None else
                         encode_parts(serialize_parts(arrays), self.codec))
            # memoryview parts are re-readable, so a retry re-issues the
            # same vectored write without re-encoding
            self._with_retry("write", key,
                             lambda: self.backend.write_parts(key, parts))
            nbytes = sum(memoryview(p).nbytes for p in parts)
            dt = self._throttle(nbytes, t0)
            store_sp.set(bytes=nbytes)
        self.stats.bytes_offloaded += nbytes
        self.stats.bytes_offloaded_logical += _nbytes(arrays)
        self.stats.store_time += dt
        self.stats.num_stores += 1
        with job.cond:
            keys, job.reg_keys = job.reg_keys, ()
        for bkey, tid in keys:
            self.registry.release_key(bkey, tid)
        lease = None
        with job.cond:
            job.arrays = job.blob = None   # the blob is stored: free it
            job.state = DONE
            orphaned = job.orphaned
            if orphaned or not job.forwarded:
                # nothing else reads the host copy (a forwarded one's
                # record gives it back when it is dropped)
                lease, job.lease = job.lease, None
            h2d_done = job.h2d_done
            job.cond.notify_all()
        self._release_after(lease, h2d_done)
        self.tracker.free((job.key, "s"), tag=f"offloaded:{job.key}")
        if self.on_landed is not None and not orphaned:
            self.on_landed(job.key)
        if orphaned:
            # dropped while writing; a new record under the same key can
            # only appear under _lock, so check and delete under it
            with self._lock:
                if job.key not in self._records:
                    self.backend.delete(key)

    def _load(self, job: _Job) -> None:
        with job.cond:
            job.state = RUNNING
        t0 = time.perf_counter()
        key = str(job.key)
        with self._lock:
            rec = self._records.get(job.key)
        if rec is not None and rec.get("remote") \
                and self.remote_wait is not None:
            self.remote_wait(job.key)
            t0 = time.perf_counter()
        lease = None
        with obs.span(LOAD_SPAN, cat="spool", key=key) as load_sp:
            # pooled load: size the blob, readinto a leased aligned
            # buffer, deserialize views over it. RAM-backed stores hand
            # their blob back by reference: staging it would only add a
            # copy
            nbytes = None if self.backend.zero_copy_read else \
                self._with_retry("read", key, lambda: self.backend.size(key))
            if nbytes:
                self._reap()
                lease = self.pool.acquire(nbytes)
                try:
                    # the lease is reused across attempts: a retried
                    # readinto just overwrites it
                    blob = self._with_retry(
                        "read", key,
                        lambda: self.backend.readinto(key, lease.mv))
                except BaseException:
                    lease.release()
                    raise
            else:
                blob = self._with_retry("read", key,
                                        lambda: self.backend.read(key))
            nread = len(blob)
            try:
                with obs.span(DECODE_SPAN, cat="codec", key=key):
                    payload, aliases = unpack_aliased(blob)
                    arrays = deserialize_leaves(payload, copy=False)
            except BaseException:
                if lease is not None:
                    lease.release()
                raise
            del blob, payload
            if lease is not None and not aliases:
                # a decoding codec handed back fresh memory: nothing
                # borrows the lease, so it goes back now
                lease.release()
                lease = None
            if rec is not None and self._on_cuda(rec) and lease is None:
                # not in the (registered) pool: a decoded payload or a
                # RAM backend's blob is pinned, so the copy back to the
                # card runs asynchronously
                arrays = [a.pin_memory() for a in arrays]
            dt = self._throttle(nread, t0)
            load_sp.set(bytes=nread)
        self.stats.bytes_loaded += nread
        self.stats.load_time += dt
        self.stats.num_loads += 1
        with self._lock:
            # the record this load was issued for, not a newer one of
            # its key
            if rec is not None and self._records.get(job.key) is rec:
                rec["loaded"], rec["load_lease"] = arrays, lease
                lease = None
        if lease is not None:
            # the record was dropped while loading: nothing reads it
            lease.release()
        with job.cond:
            job.state = DONE
            job.cond.notify_all()


__all__ = ["ActivationSpool", "SpoolLoadError", "SpoolStepTransaction",
           "SpoolStats", "build_spool", "MIN_OFFLOAD_ELEMENTS"]
