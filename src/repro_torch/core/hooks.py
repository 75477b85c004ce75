"""The mesh half of the JAX package's jit-engine hooks
(`repro/core/hooks.py:91-371`): how a layer's saved tensors split across
a mesh, and the bridge that keys the spool's leases by step and shard.

The JAX engine hands each device's local residual shard to one
`HookBridge` per host from XLA host-callback threads. The port runs one
process per rank, and each rank's engine hands its own bridge its own
saved tensors (`core/engine.py`); the plan below is computed once per
engine, as every layer stage's saved tensors split alike.

`plan_shards` picks a spec per saved leaf: the leading (batch) dim over
the dp axes, the innermost other divisible dim over tp. Axes that shard
no leaf are replica axes: ranks that differ only along them hold the
same bytes. Leases are shard-qualified, ``jit{step}/s{shard}``, the shard
being the rank's linear index over the writer axes.

Replica dedup (`dedupe_replicas`, on by default): only the primary
replica (replica index 0) stores a stage, recorded with
``consumers=n_replicas``; the others skip the store and count
`replica_skips`, and every replica's backward fetch counts the stage
down; the last drops it. Without dedup every rank stores its own copy
under shard ``shard * n_replicas + replica``.

In the JAX package the replicas are devices of one process. In the port
they are processes, so (`ReplicaLink`):

  * every rank's spool writes into one directory (the session shares it),
    and a replica records the stage with `SpoolStepTransaction.adopt`:
    its own identical saved tensors give the layout, the data is read
    from the primary's blob;
  * the primary's spool marks a key in the process group's store once
    the blob has landed (`ActivationSpool.on_landed`), and a replica's
    fetch (and any load of an adopted record) waits for that mark, at
    most `fetch_timeout` seconds (`DEFAULT_FETCH_TIMEOUT_S`), in the
    `hook.wait_store` span;
  * a replica that has read the blob adds one to the key's count in the
    store; the primary counts its own fetch down locally and releases
    one consumer per remote count (`settle`, called at the end of each
    backward, waits for the rest), so the last read anywhere drops the
    record and deletes the blob: the countdown across ranks.

The `mem` backend is a dict in one process and cannot be shared: a
session refuses it for dedup across ranks.

Per-shard counters (`stats_by_shard`): offloads, fetches, replica_skips,
degraded_fetches, bytes_in, bytes_out, keyed by shard id (None on one
device). Each rank counts its own calls; the session sums the ranks'.
Events: `hook.offload`, `hook.fetch`, `hook.wait_store` spans and the
`hook.replica_skip` instant, each with its `shard`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.cache.horizon import reuse_horizon
from repro_torch.core.spool import ActivationSpool, SpoolStepTransaction
from repro_torch.parallel.mesh import (axes_size, canonical_axis_entry,
                                       local_shape, spec_axes)

#: how long a fetch waits for its matching offload before giving up: a
#: replica's backward can reach a stage before the primary's store of it
#: has landed
DEFAULT_FETCH_TIMEOUT_S = 120.0


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


@dataclass(frozen=True)
class ShardPlan:
    """How one hooked stage's saved leaves split across a mesh.

    `specs[i]` is leaf i's spec; `writer_axes` are the mesh axes that
    shard at least one leaf (ranks differing only along the remaining
    `replica_axes` hold identical bytes). The shard id in spool keys is
    the linear index over `writer_axes`; the replica id over
    `replica_axes` selects which duplicate stores."""

    mesh: Any
    specs: Tuple[Any, ...]
    writer_axes: Tuple[str, ...]
    replica_axes: Tuple[str, ...]

    @property
    def n_shards(self) -> int:
        return axes_size(self.mesh, self.writer_axes)

    @property
    def n_replicas(self) -> int:
        return axes_size(self.mesh, self.replica_axes)

    def local_shapes(self, global_shapes) -> Tuple[Tuple[int, ...], ...]:
        return tuple(local_shape(_shape(s), spec, self.mesh)
                     for s, spec in zip(global_shapes, self.specs))


def plan_shards(mesh, dp_axes, tp_axis, leaf_shapes) -> ShardPlan:
    """Pick a spec per saved leaf (anything with `.shape`, or a shape):
    leading dim over the dp axes (batch-major residuals dominate), the
    innermost other divisible dim over tp. Indivisible leaves replicate:
    their bytes are stored once per writer group, not once per rank."""
    dp_axes = tuple(a for a in (dp_axes or ())
                    if a in mesh.shape and mesh.shape[a] > 1)
    if tp_axis is not None and (tp_axis not in mesh.shape
                                or mesh.shape[tp_axis] <= 1):
        tp_axis = None
    dp_size = axes_size(mesh, dp_axes)
    specs = []
    for leaf in leaf_shapes:
        shape = _shape(leaf)
        parts: List[Any] = [None] * len(shape)
        if dp_axes and shape and shape[0] > 0 and shape[0] % dp_size == 0:
            parts[0] = canonical_axis_entry(dp_axes)
        if tp_axis is not None:
            tp = mesh.shape[tp_axis]
            for d in range(len(shape) - 1, -1, -1):
                if parts[d] is None and shape[d] > 0 and shape[d] % tp == 0:
                    parts[d] = tp_axis
                    break
        specs.append(tuple(parts))
    used = set()
    for spec in specs:
        used.update(spec_axes(spec))
    writer = tuple(a for a in mesh.axis_names if a in used)
    replica = tuple(a for a in mesh.axis_names if a not in used)
    return ShardPlan(mesh=mesh, specs=tuple(specs), writer_axes=writer,
                     replica_axes=replica)


class ReplicaLink:
    """The cross-process half of replica dedup, over a
    `torch.distributed` store (the process group's): a "landed" mark per
    key, set by the primary, and a count of the replicas that have read
    it. `prefix` keeps one session's keys apart from another's."""

    def __init__(self, store, prefix: str,
                 timeout: float = DEFAULT_FETCH_TIMEOUT_S):
        self.store, self.prefix, self.timeout = store, prefix, timeout
        self._lock = threading.Lock()

    def _k(self, key, what: str) -> str:
        return f"{self.prefix}/{key}/{what}"

    def landed(self, key) -> None:
        with self._lock:
            self.store.set(self._k(key, "landed"), "1")

    def wait_landed(self, key, timeout: Optional[float] = None) -> None:
        """Block until `key`'s blob has landed; KeyError after the bound."""
        wait = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + wait
        name = self._k(key, "landed")
        pause = 1e-4
        while True:
            with self._lock:
                if self.store.check([name]):
                    return
            if time.monotonic() >= deadline:
                raise KeyError(f"no landed store of {key!r} after "
                               f"{wait:.0f}s — did the primary replica "
                               f"store it?")
            time.sleep(pause)
            pause = min(2 * pause, 5e-3)

    def read(self, key) -> None:
        with self._lock:
            self.store.add(self._k(key, "reads"), 1)

    def reads(self, key) -> int:
        with self._lock:
            return int(self.store.add(self._k(key, "reads"), 0))

    def forget(self, key) -> None:
        with self._lock:
            for what in ("landed", "reads"):
                try:
                    self.store.delete_key(self._k(key, what))
                except (RuntimeError, NotImplementedError):
                    pass


class HookBridge:
    """The spool endpoint of the mesh hooks: one transactional lease per
    step and shard (``jit{step}`` on one device, ``jit{step}/s{shard}``
    on a mesh), closed when its last stage is consumed. With a `link`
    the replicas are other processes (see the module docstring)."""

    def __init__(self, spool: ActivationSpool, *, key_prefix: str = "jit",
                 dedupe_replicas: bool = True,
                 fetch_timeout: float = DEFAULT_FETCH_TIMEOUT_S,
                 link: Optional[ReplicaLink] = None):
        self.spool = spool
        self.dedupe_replicas = dedupe_replicas
        self.fetch_timeout = fetch_timeout
        self.link = link
        self._prefix = key_prefix
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._txs: Dict[str, SpoolStepTransaction] = {}
        self._shard_stats: Dict[Any, Dict[str, int]] = {}
        # primary: (step id, stage) -> {tx, key, n remote readers,
        # released}: a stage other processes read
        self._remote: Dict[Tuple[str, Any], Dict[str, Any]] = {}
        self._shared_keys: set = set()      # their spool keys
        if link is not None:
            spool.on_landed = self._on_landed
            spool.remote_wait = link.wait_landed

    def stats_by_shard(self) -> Dict[Any, Dict[str, int]]:
        """Per-shard callback traffic of this process: offloads / fetches
        / replica_skips counts and logical bytes each way."""
        with self._lock:
            return {k: dict(v) for k, v in self._shard_stats.items()}

    def _note(self, shard, field: str, n: int = 1) -> None:
        with self._lock:
            rec = self._shard_stats.setdefault(shard, {
                "offloads": 0, "fetches": 0, "replica_skips": 0,
                "degraded_fetches": 0, "bytes_in": 0, "bytes_out": 0})
            rec[field] += n

    def _step_id(self, step, shard) -> str:
        base = f"{self._prefix}{step}"
        return base if shard is None else f"{base}/s{shard}"

    def _tx(self, step_id: str) -> SpoolStepTransaction:
        with self._lock:
            tx = self._txs.get(step_id)
            if tx is None:
                tx = self.spool.step(step_id)
                self._txs[step_id] = tx
            return tx

    def _on_landed(self, key) -> None:
        with self._lock:
            shared = key in self._shared_keys
        if shared:
            self.link.landed(key)

    # ------------------------------------------------------------- API

    def offload(self, step, stage, arrays: List[Any], *, shard=None,
                consumers: int = 1) -> None:
        """Store one stage's saved tensors under the (step, shard) lease;
        `consumers` is how many fetches the stage expects (one per
        replica)."""
        with obs.span("hook.offload", cat="hook", step=step, stage=stage,
                      shard=shard) as sp:
            step_id = self._step_id(step, shard)
            tx = self._tx(step_id)
            if self.link is not None and consumers > 1:
                # read by replicas in other processes: each read they
                # report releases one consumer (`_poll`)
                with self._lock:
                    self._shared_keys.add(tx.key(stage))
                    self._remote[(step_id, stage)] = {
                        "tx": tx, "key": tx.key(stage), "n": consumers - 1,
                        "released": 0}
            tx.offload(stage, list(arrays), consumers=consumers)
            nbytes = int(sum(a.numel() * a.element_size() for a in arrays))
            sp.set(bytes=nbytes)
        self._note(shard, "offloads")
        self._note(shard, "bytes_in", nbytes)
        with self._cv:
            self._cv.notify_all()

    def sharded_offload(self, step, stage, arrays: List[Any], *,
                        shard: int, replica: int, n_replicas: int) -> None:
        """Mesh entry point: with replica dedup the primary replica stores
        once for its replica group (a replica in another process records
        the stage to read the primary's blob); without it every rank
        stores its own copy under a replica-qualified shard."""
        if self.dedupe_replicas and n_replicas > 1:
            if replica == 0:
                self.offload(step, stage, arrays, shard=shard,
                             consumers=n_replicas)
            else:
                if self.link is not None:
                    self._tx(self._step_id(step, shard)).adopt(
                        stage, list(arrays))
                self._note(shard, "replica_skips")
                obs.instant("hook.replica_skip", cat="hook", step=step,
                            stage=stage, shard=shard, replica=replica)
        else:
            self.offload(step, stage, arrays,
                         shard=shard * n_replicas + replica)

    def fetch(self, step, stage, *, shard=None, remote: bool = False
              ) -> List[Any]:
        """Blocking fetch of one stage's saved tensors, prefetching the
        stages below first (one module ahead). Counts the stage's
        consumers down; the last fetch drops it, and the (step, shard)
        lease closes when its last live stage is consumed. A sharded
        fetch waits (bounded) for its store: the replica that stores may
        be another thread or another process. `remote`: this process's
        record is adopted, and its read is reported to the primary."""
        step_id = self._step_id(step, shard)
        wait = self.fetch_timeout if shard is not None else 0.0
        deadline = time.monotonic() + wait
        with obs.span("hook.fetch", cat="hook", step=step, stage=stage,
                      shard=shard) as fsp:
            with obs.span("hook.wait_store", cat="hook", step=step,
                          stage=stage, shard=shard):
                with self._cv:
                    while True:
                        tx = self._txs.get(step_id)
                        if tx is not None and tx.has_stage(stage):
                            break
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise KeyError(
                                f"no live spool record for step "
                                f"{step_id!r} stage {stage} after "
                                f"{wait:.0f}s — was its offload dropped?")
                        self._cv.wait(timeout=min(left, 1.0))
                if remote:
                    self.link.wait_landed(tx.key(stage), self.fetch_timeout)
            for s in reuse_horizon(range(stage - 1, -1, -1)):
                tx.prefetch(s)
            key = tx.key(stage)
            out = tx.consume(stage)
            nbytes = int(sum(a.numel() * a.element_size() for a in out))
            fsp.set(bytes=nbytes)
        if remote:
            self.link.read(key)
        self._note(shard, "fetches")
        self._note(shard, "bytes_out", nbytes)
        self._poll()
        self._maybe_close(step_id, tx)
        return list(out)

    def sharded_fetch(self, step, stage, *, shard: int, replica: int,
                      n_replicas: int) -> List[Any]:
        if self.dedupe_replicas and n_replicas > 1:
            return self.fetch(step, stage, shard=shard,
                              remote=self.link is not None and replica != 0)
        return self.fetch(step, stage, shard=shard * n_replicas + replica)

    def _maybe_close(self, step_id: str, tx) -> None:
        with self._lock:
            if not tx.live_stages and self._txs.get(step_id) is tx:
                del self._txs[step_id]
                tx.close()

    def _poll(self) -> int:
        """Release one consumer of the primary's shared stages per remote
        read since the last poll; returns how many stages still await
        reads."""
        if self.link is None:
            return 0
        with self._lock:
            pending = list(self._remote.items())
        for (step_id, stage), rec in pending:
            reads = self.link.reads(rec["key"])
            while rec["released"] < min(reads, rec["n"]):
                rec["tx"].release(stage)
                rec["released"] += 1
            if rec["released"] == rec["n"]:
                with self._lock:
                    self._remote.pop((step_id, stage), None)
                    self._shared_keys.discard(rec["key"])
                self.link.forget(rec["key"])
                self._maybe_close(step_id, rec["tx"])
        with self._lock:
            return len(self._remote)

    def settle(self) -> None:
        """Wait (at most `fetch_timeout`) until every remote replica has
        read the primary's stages, releasing them: the end of a
        backward."""
        deadline = time.monotonic() + self.fetch_timeout
        pause = 1e-4
        while self._poll():
            if time.monotonic() >= deadline:
                with self._lock:
                    keys = sorted(r["key"] for r in self._remote.values())
                raise KeyError(f"the replicas did not read {keys} within "
                               f"{self.fetch_timeout:.0f}s")
            time.sleep(pause)
            pause = min(2 * pause, 5e-3)

    def close(self) -> None:
        """Drop any leftover leases (a step aborted mid-backward)."""
        with self._lock:
            txs, self._txs = list(self._txs.values()), {}
            self._remote.clear()
        for tx in txs:
            tx.close()


__all__ = ["DEFAULT_FETCH_TIMEOUT_S", "HookBridge", "ReplicaLink",
           "ShardPlan", "plan_shards"]
