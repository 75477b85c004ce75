"""ActivationSpool — the tensor cache's I/O engine (paper §3.2-3.3.2),
ported from the JAX package's `repro/core/spool.py` and limited to what
serving uses.

Two FIFO thread pools, store and load:

  * offload(key, tree): enqueue an async store of a tree of CPU tensors;
    the spool holds the only reference until the write lands.
  * prefetch(key): enqueue an async load.
  * fetch(key): blocking. If the store is still queued or in flight,
    the in-memory reference is forwarded (§3.3.2) and a still-queued
    store is cancelled (§3.3.3 feature 1).
  * lease(id): a transactional lease over records (`SpoolStepTransaction`);
    closing it drops every record it still holds, on success and error.

Blobs are RSA2 serde (`repro_torch.io.serde`) inside the codec container,
so the JAX package can read them and the port can read the JAX
package's. Dedup by tensor identity, the pooled-buffer load path,
retry/health and the managed/striped/tiered/aio backends are not ported
yet.
"""
from __future__ import annotations

import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.io.backend import StorageBackend
from repro_torch.io.backends import FilesystemBackend, HostMemoryBackend
from repro_torch.io.codecs import Codec, encode_parts, get_codec, unpack
from repro_torch.io.serde import deserialize_leaves, serialize_parts

# job states
QUEUED, RUNNING, DONE, CANCELED = range(4)

# paper Algorithm 2 line 12: tensors smaller than 2**20 elements stay put
MIN_OFFLOAD_ELEMENTS = 2 ** 20


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


# ------------------------------------------------------------- config

def build_backend(io_cfg) -> Tuple[StorageBackend, List[str]]:
    """(backend, owned temp dirs) for a SpoolIoConfig."""
    io_cfg.validate()
    if io_cfg.backend == "mem":
        return HostMemoryBackend(), []
    directory = io_cfg.directory
    owned = []
    if directory is None:
        directory = tempfile.mkdtemp(prefix="tba_spool_")
        owned.append(directory)
    return FilesystemBackend(directory), owned


def build_spool(io_cfg, *, min_offload_elements: int = MIN_OFFLOAD_ELEMENTS
                ) -> "ActivationSpool":
    """A spool over the storage a SpoolIoConfig selects; a temp dir it
    creates is removed by `spool.close()`. Serving passes
    min_offload_elements=0: KV pages are small and must reach storage."""
    backend, owned = build_backend(io_cfg)
    return ActivationSpool(backend, codec=io_cfg.codec,
                           store_threads=io_cfg.store_threads,
                           load_threads=io_cfg.load_threads,
                           min_offload_elements=min_offload_elements,
                           owned_dirs=owned)


@dataclass
class SpoolStats:
    bytes_offloaded: int = 0            # encoded bytes written
    bytes_loaded: int = 0
    bytes_forwarded: int = 0
    stores_canceled: int = 0
    store_time: float = 0.0
    load_time: float = 0.0
    num_stores: int = 0
    num_loads: int = 0
    # time the consumer spent blocked waiting for a load: the I/O
    # latency exposed on the critical path
    fetch_wait_time: float = 0.0


class _Job:
    __slots__ = ("key", "arrays", "state", "cond", "kind", "orphaned",
                 "error")

    def __init__(self, key, arrays, kind):
        self.key = key
        self.arrays = arrays
        self.state = QUEUED
        self.cond = threading.Condition()
        self.kind = kind          # "store" | "load"
        self.orphaned = False     # dropped while the store was running
        self.error = None         # exception raised by the worker


class SpoolStepTransaction:
    """Transactional lease on a set of spool records. Stages are
    addressed by index and keyed ``{lease_id}_s{stage}``; `close` drops
    every record not consumed yet, so an aborted user never strands
    blobs on the backend. The paged KV cache opens one lease per served
    sequence, with logical page indices as stages."""

    __slots__ = ("_spool", "step_id", "_live", "_closed", "_tlock")

    def __init__(self, spool: "ActivationSpool", step_id: str):
        self._spool = spool
        self.step_id = step_id
        self._live: Dict[Any, str] = {}     # stage -> spool key
        self._closed = False
        self._tlock = threading.Lock()

    def key(self, stage) -> str:
        return f"{self.step_id}_s{stage}"

    def offload(self, stage, tree) -> None:
        """Async-store a stage's tree of CPU tensors under this lease."""
        with self._tlock:
            if self._closed:
                raise RuntimeError(
                    f"spool lease {self.step_id!r} is closed")
            if stage in self._live:
                raise KeyError(f"stage {stage!r} already live in lease "
                               f"{self.step_id!r}")
            key = self._live[stage] = self.key(stage)
        self._spool.offload(key, tree)

    def has_stage(self, stage) -> bool:
        with self._tlock:
            return stage in self._live

    def prefetch(self, stage) -> None:
        """Hint an async load; an unknown stage is ignored."""
        with self._tlock:
            key = self._live.get(stage)
        if key is not None:
            self._spool.prefetch(key)

    def fetch(self, stage):
        """Blocking: the stage's tree (forwarded or reloaded)."""
        with self._tlock:
            key = self._live.get(stage)
        if key is None:
            raise KeyError(f"stage {stage!r} not recorded in lease "
                           f"{self.step_id!r}")
        return self._spool.fetch(key)

    def consume(self, stage):
        """Fetch the stage's tree and drop the record (memory + blob)."""
        out = self.fetch(stage)
        self.drop(stage)
        return out

    def drop(self, stage) -> None:
        with self._tlock:
            key = self._live.pop(stage, None)
        if key is not None:
            self._spool.drop(key)

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
                 min_offload_elements: int = MIN_OFFLOAD_ELEMENTS,
                 owned_dirs: Tuple[str, ...] = ()):
        self.backend = backend
        self.codec = get_codec(codec)
        self.min_offload_elements = min_offload_elements
        self.stats = SpoolStats()
        self._owned_dirs = list(owned_dirs)
        self._lock = threading.Lock()
        self._records: Dict[Any, Dict] = {}
        self._leases: set = set()
        self._store_q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._load_q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._closed = False
        self._n_threads = {"store": store_threads, "load": load_threads}
        self._threads: List[threading.Thread] = []
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

    def _release_lease(self, lease_id: str) -> None:
        with self._lock:
            self._leases.discard(lease_id)

    def offload(self, key, tree) -> None:
        """Async-store a tree of CPU tensors under `key`. Leaves smaller
        than `min_offload_elements` stay in memory (recorded, not
        written)."""
        leaves, treedef = tree_flatten(tree)
        keep_idx = [i for i, t in enumerate(leaves)
                    if t.numel() < self.min_offload_elements]
        spool_idx = [i for i in range(len(leaves)) if i not in keep_idx]
        spooled = [leaves[i] for i in spool_idx]
        job = _Job(key, spooled, "store") if spool_idx else None
        with self._lock:
            if key in self._records:
                raise KeyError(f"spool key {key!r} is already live")
            self._records[key] = {
                "treedef": treedef, "keep": {i: leaves[i] for i in keep_idx},
                "spool_idx": spool_idx, "n_leaves": len(leaves),
                "job": job, "nbytes": _nbytes(spooled), "loaded": None,
                "load_job": None, "fwd_counted": False,
            }
        if job is not None:
            self._store_q.put(job)

    def prefetch(self, key) -> None:
        with self._lock:
            rec = self._records.get(key)
            if rec is None or rec["job"] is None:
                return
            job = rec["job"]
            with job.cond:
                if job.arrays is not None:
                    # still in memory (in flight, cancelled or failed):
                    # fetch forwards the reference, nothing to read
                    return
            if rec["load_job"] is not None or rec["loaded"] is not None:
                return
            lj = rec["load_job"] = _Job(key, None, "load")
        self._load_q.put(lj)

    def fetch(self, key):
        """Blocking: the full tree of `key`, as CPU tensors."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                raise KeyError(key)
        job = rec["job"]
        spooled = None
        if job is not None:
            with job.cond:
                if job.arrays is not None:
                    # tensor forwarding (§3.3.2): the store is queued, in
                    # flight, cancelled or failed — its tensors are still
                    # here, so hand them over instead of reading storage
                    spooled = job.arrays
                    if not rec["fwd_counted"]:
                        rec["fwd_counted"] = True
                        self.stats.bytes_forwarded += rec["nbytes"]
                    if job.state == QUEUED:
                        job.state = CANCELED
                        self.stats.stores_canceled += 1
            if spooled is None:
                self.prefetch(key)
                with self._lock:
                    lj = rec["load_job"]
                t0 = time.perf_counter()
                with lj.cond:
                    while lj.state not in (DONE, CANCELED):
                        lj.cond.wait()
                self.stats.fetch_wait_time += time.perf_counter() - t0
                if lj.error is not None:
                    raise RuntimeError(
                        f"spool load failed for {key!r}") from lj.error
                with self._lock:
                    spooled = rec["loaded"]
        leaves = [None] * rec["n_leaves"]
        for i, leaf in rec["keep"].items():
            leaves[i] = leaf
        for i, leaf in zip(rec["spool_idx"], spooled or ()):
            leaves[i] = leaf
        return tree_unflatten(rec["treedef"], leaves)

    def drop(self, key) -> None:
        """Consume a record: free its memory and delete its blob."""
        with self._lock:
            rec = self._records.pop(key, None)
        if rec is None or rec["job"] is None:
            return
        job = rec["job"]
        with job.cond:
            if job.state == QUEUED:
                # never written: the worker skips the cancelled write
                job.state = CANCELED
                self.stats.stores_canceled += 1
                return
            if job.state == RUNNING:
                # the write lands after this drop: the worker deletes it
                job.orphaned = True
                return
        self.backend.delete(str(key))

    def live_keys(self) -> List:
        with self._lock:
            return list(self._records)

    def wait_io(self) -> None:
        """Barrier: wait for every queued store and load."""
        self._store_q.join()
        self._load_q.join()

    def close(self) -> None:
        """Drain queued I/O, stop and join the workers, close the
        backend and remove the temp dirs the spool owns. Idempotent."""
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
        self.backend.close()
        for d in self._owned_dirs:
            shutil.rmtree(d, ignore_errors=True)

    # --------------------------------------------------------- workers

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
        with job.cond:
            if job.state == CANCELED:
                job.cond.notify_all()
                return
            job.state = RUNNING
            arrays = job.arrays
        t0 = time.perf_counter()
        parts = encode_parts(serialize_parts(arrays), self.codec)
        self.backend.write_parts(str(job.key), parts)
        nbytes = sum(memoryview(p).nbytes for p in parts)
        self.stats.bytes_offloaded += nbytes
        self.stats.store_time += time.perf_counter() - t0
        self.stats.num_stores += 1
        with job.cond:
            job.arrays = None          # the blob is stored: free the tensors
            job.state = DONE
            orphaned = job.orphaned
            job.cond.notify_all()
        if orphaned:
            # dropped while writing; a new record under the same key can
            # only appear under _lock, so check and delete under it
            with self._lock:
                if job.key not in self._records:
                    self.backend.delete(str(job.key))

    def _load(self, job: _Job) -> None:
        with job.cond:
            job.state = RUNNING
        t0 = time.perf_counter()
        blob = self.backend.read(str(job.key))
        arrays = deserialize_leaves(unpack(blob))
        self.stats.bytes_loaded += len(blob)
        self.stats.load_time += time.perf_counter() - t0
        self.stats.num_loads += 1
        with self._lock:
            rec = self._records.get(job.key)
            if rec is not None:
                rec["loaded"] = arrays
        with job.cond:
            job.state = DONE
            job.cond.notify_all()


__all__ = ["ActivationSpool", "SpoolStepTransaction", "SpoolStats",
           "build_spool", "build_backend", "MIN_OFFLOAD_ELEMENTS"]
