"""Eager per-layer optimizer updates overlapped with backward, the port
of the JAX package's `repro/optim/overlap.py` (`OptBridge`).

The serial step runs forward -> backward -> one fused optimizer update,
so with `host_offload="opt_state"` every step pays the whole optimizer
state's round trip between steps. The bridge hides it: the moment layer
*i*'s gradients are finished in backward (the engine's gradient tap,
`settings.opt_sink`), layer *i*'s moments are fetched from the spool,
the update runs and the new moments are staged back, while the card is
still computing layer *i-1*'s backward.

  * `on_grads(step, stage, leaves)` is the tap. It runs on the training
    thread right after the stage's gradients were added, so it only
    records a CUDA event on the training stream (the gradients' point of
    completion) and enqueues.
  * a worker thread drains the queue (`_process`): per stage it peeks
    the stage's moment lease onto the host (`opt.fetch`; the leaves stay
    in their pooled lease), prefetches the next stages in backward
    order `PREFETCH_DEPTH` ahead (`reuse_horizon`), and runs the
    optimizer's `leaf_update` (`engine.opt_update`) in slices of at most
    `CHUNK` elements on a side stream that waits on the tap's event:
    each slice of the old moments goes to the card, is updated, the new
    parameters are written in place into the stacked parameter and the
    new moments are copied into a pool lease laid out as their blob
    (`spool.host_layout`). A layer's moments are never on the card
    whole, only a slice at a time.
  * write-back: moments whose bits did not change (compared on the
    card) keep their lease instead of rewriting the spool
    (`opt.stage_skip`, `spool.stats.opt_skipped_bytes`); changed ones
    are staged under the next step's lease (`opt.stage`) and the old
    lease is closed.
  * `finish_step` joins the worker (`engine.opt_join`, the only exposure
    the overlap leaves), makes the training stream wait for the side
    stream, and updates the rest of the tree (embeddings, head, norms;
    its moments stay on the device) with the same kernel.

Streams: the side stream waits on each tap's event, and every tensor the
worker reads but did not allocate (gradient slices, parameter views) is
`record_stream`ed on it; the old moments' host leases are read by
asynchronous copies, so the worker waits for its stream before it closes
a lease or stages a new one.

Bitwise contract: `leaf_update` is the very function the fused
`Optimizer.update` applies to each slice, and each element's sequence of
operations does not depend on the slicing, so the eager worker and
`eager=False` ("sync": the same taps and kernels, drained in
`finish_step`) give the serial fused update's bytes. Global-norm
clipping needs every gradient before any update, so the bridge refuses
a clipping optimizer.

Moment leases are per (step, stage): `spool.step(f"opt{step}L{stage}")`
with the payload at stage 0 (spool keys `opt{step}L{stage}_s0`), stages
numbered as the JAX package numbers them (decoder layers from 0, encoder
layers from `ENC_STAGE_BASE`); the `opt` prefix is what the cache
manager's opt_state class and the trace analyzer classify on. On a mesh
each rank runs its own bridge over its ZeRO-1 shards (the tap fires
after the engine's gradient reduction, so its leaves are this rank's
shards), and the ranks share one spool directory: `lease_suffix` (the
rank's shard, `/s{rank}`) makes the keys `opt{step}L{stage}/s{rank}`,
so two ranks' leases never name one blob. One departure: the port's
optimizers update in place, so the JAX bridge's `_restack` is the worker
writing each layer's slice of `params[key][si]` where it lies.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.cache.horizon import reuse_horizon
from repro_torch.core.engine import ENC_STAGE_BASE
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.optim.optimizers import Optimizer, OptState, _slices

#: how long finish_step waits for the worker to drain before declaring
#: the step lost (a tap that never fired or a wedged backend)
DEFAULT_JOIN_TIMEOUT_S = 120.0

#: stages ahead, in backward-arrival order, whose moment reads the worker
#: keeps in flight (2: the next tap's read is already under way)
PREFETCH_DEPTH = 2

_SCAN_KEYS = (("segments", 0), ("enc_segments", ENC_STAGE_BASE))


def _layout_from(params) -> Dict[int, tuple]:
    """stage -> (tree key, segment index, in-segment layer index) for
    every stacked layer, numbered as the engine's gradient tap numbers
    them."""
    layout: Dict[int, tuple] = {}
    for tree_key, base in _SCAN_KEYS:
        stacks = params.get(tree_key) if isinstance(params, dict) else None
        if not stacks:
            continue
        layer0 = 0
        for si, stack in enumerate(stacks):
            n = int(tree_flatten(stack)[0][0].shape[0])
            for li in range(n):
                layout[base + layer0 + li] = (tree_key, si, li)
            layer0 += n
    return layout


def _arrival_order(layout) -> List[int]:
    """Expected backward arrival order of the taps: decoder stages
    descending (backward walks the decoder top-down first), then the
    encoder stages descending."""
    dec = sorted((s for s in layout if s < ENC_STAGE_BASE), reverse=True)
    enc = sorted((s for s in layout if s >= ENC_STAGE_BASE), reverse=True)
    return dec + enc


def _rest(tree) -> dict:
    """The non-stacked subtree (embeddings, head, norms)."""
    return {k: v for k, v in tree.items()
            if k not in ("segments", "enc_segments")}


class OptBridge:
    """Side-stream endpoint for eager per-layer optimizer updates.

    Lifecycle per step (driven by `launch.steps.make_overlap_train_step`):
    `seed` (once) -> `begin_step` -> taps arrive through `on_grads` while
    backward runs -> `finish_step`. `materialize` reassembles the full
    OptState for checkpoints and the end of a run."""

    def __init__(self, optimizer: Optimizer, spool, *, eager: bool = True,
                 join_timeout: float = DEFAULT_JOIN_TIMEOUT_S,
                 lease_suffix: str = ""):
        if optimizer.leaf_update is None:
            raise ValueError(
                f"optimizer {optimizer.name!r} has no per-leaf update "
                f"kernel — eager overlap needs Optimizer.leaf_update")
        if optimizer.clip_norm:
            raise ValueError(
                "eager per-layer updates are incompatible with global-norm "
                "clipping (the clip needs every gradient before any "
                "update) — build the optimizer with clip_norm=None")
        self.optimizer = optimizer
        self.spool = spool
        self.eager = eager
        self.join_timeout = join_timeout
        self.lease_suffix = lease_suffix
        self._leaf_fn = optimizer.leaf_update
        self.seeded = False
        self._step: int = 0
        self._has_m = False
        self._has_n = False
        self._rest_m: Any = None
        self._rest_n: Any = None
        self._device: Optional[torch.device] = None
        self._stream = None                    # CUDA side stream
        self._mom_tx: Dict[int, Any] = {}      # stage -> live lease
        self._layout: Dict[int, tuple] = {}
        self._order: List[int] = []
        self._pos: Dict[int, int] = {}
        self._seg_meta: Dict[tuple, tuple] = {}    # (key, si) -> (tdef, n)
        self._seg_leaves: Dict[tuple, list] = {}   # (key, si) -> leaves
        self._pending: set = set()
        self._error: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._moment_bytes = 0
        self.counters = {"opt_updates": 0, "opt_stage_skips": 0,
                         "opt_fetched_bytes": 0, "opt_staged_bytes": 0,
                         "opt_skipped_bytes": 0}

    # ------------------------------------------------------------ seeding

    def seed(self, opt_state: OptState, params) -> None:
        """Adopt a full OptState: the layers' moments are split per stage
        and staged to the spool; the rest of the tree stays where it is
        (the bridge holds those moments from now on). Idempotent via
        `seeded`."""
        if self.seeded:
            return
        self._step = int(opt_state.step)
        self._device = tree_flatten(params)[0][0].device
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._layout = _layout_from(params)
        self._order = _arrival_order(self._layout)
        self._pos = {s: i for i, s in enumerate(self._order)}
        for tree_key, _ in _SCAN_KEYS:
            for si, stack in enumerate(params.get(tree_key) or ()):
                leaves, treedef = tree_flatten(stack)
                self._seg_meta[(tree_key, si)] = (
                    treedef, int(leaves[0].shape[0]))
        self._has_m = opt_state.mu is not None
        self._has_n = opt_state.nu is not None
        if self._has_m:
            self._rest_m = _rest(opt_state.mu)
        if self._has_n:
            self._rest_n = _rest(opt_state.nu)
        if self._has_m:
            if self._stream is not None:
                # the moments were written on the training stream
                self._stream.wait_stream(
                    torch.cuda.current_stream(self._device))
            with self._on_stream():
                for stage, (key, si, li) in self._layout.items():
                    payload = self._slice_moments(opt_state, key, si, li)
                    self._mom_tx[stage] = self._stage_out(
                        self._lease_id(self._step, stage), payload)
                    self._moment_bytes += sum(
                        t.numel() * t.element_size() for t in payload)
        self.seeded = True
        if self.eager and self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, name="opt-overlap", daemon=True)
            self._worker.start()

    def ensure_seeded(self, opt_state: OptState, params) -> None:
        self.seed(opt_state, params)

    def _slice_moments(self, opt_state, key, si, li) -> List[torch.Tensor]:
        out = [leaf[li] for leaf in tree_flatten(opt_state.mu[key][si])[0]]
        if self._has_n:
            out += [leaf[li]
                    for leaf in tree_flatten(opt_state.nu[key][si])[0]]
        return out

    def _lease_id(self, step: int, stage: int) -> str:
        return f"opt{step}L{stage}{self.lease_suffix}"

    def lease_ids(self) -> List[str]:
        """The moment leases the bridge holds now."""
        return sorted(tx.step_id for tx in self._mom_tx.values())

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        """Wait for the side stream's copies (a lease they read or fill
        is closed or handed to the spool next)."""
        if self._stream is not None:
            self._stream.synchronize()

    def _stage_out(self, lease_id: str, tensors) -> Any:
        """Copy `tensors` into one pool lease laid out as their blob and
        store it under a new lease `lease_id`, stage 0."""
        host, lease, blob = self.spool.host_layout(tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        self._sync()
        tx = self.spool.step(lease_id)
        tx.offload_staged(0, host, lease, blob, device=self._device)
        return tx

    # ------------------------------------------------------ per-step API

    def begin_step(self, params, step: int) -> None:
        """Arm the bridge for one step: record the stacked parameter
        leaves the worker writes, reset the pending-stage set, and warm
        the first expected fetches."""
        if step != self._step:
            raise RuntimeError(
                f"opt bridge is at step {self._step}, got {step}")
        if self._error is not None:
            raise RuntimeError("opt bridge failed on a previous step") \
                from self._error
        self._seg_leaves = {}
        for tree_key, _ in _SCAN_KEYS:
            for si, stack in enumerate(params.get(tree_key) or ()):
                self._seg_leaves[(tree_key, si)] = tree_flatten(stack)[0]
        with self._cv:
            self._pending = set(self._layout)
        for s in reuse_horizon(self._order, depth=PREFETCH_DEPTH):
            tx = self._mom_tx.get(s)
            if tx is not None:
                tx.prefetch(0)

    def on_grads(self, step: int, stage: int, leaves) -> None:
        """The gradient tap, on the training thread: record where the
        gradients are finished on the training stream, and enqueue."""
        event = None
        if leaves and leaves[0].is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaves[0].device))
        self._queue.put((step, stage, leaves, event))

    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            stage = item[1]
            try:
                self._process(*item)
            except BaseException as e:  # surfaced by finish_step
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._pending.discard(stage)
                    self._cv.notify_all()

    def _process(self, step: int, stage: int, gleaves, event=None) -> None:
        info = self._layout.get(stage)
        if info is None:
            raise KeyError(f"grad tap for unknown stage {stage}")
        key, si, li = info
        p_leaves = [p[li] for p in self._seg_leaves[(key, si)]]
        new_step = step + 1
        n = len(gleaves)
        with self._on_stream():
            if event is not None:
                self._stream.wait_event(event)
                for t in list(gleaves) + p_leaves:
                    t.record_stream(self._stream)
            self._update_layer(step, stage, p_leaves, gleaves, new_step, n)

    def _update_layer(self, step, stage, p_leaves, gleaves, new_step, n):
        old: Optional[List[torch.Tensor]] = None
        if self._has_m:
            tx = self._mom_tx[stage]
            with obs.span("opt.fetch", cat="opt", step=step, stage=stage,
                          key=tx.step_id) as sp:
                old = tx.peek(0, to_device=False)
                nbytes = sum(t.numel() * t.element_size() for t in old)
                sp.set(bytes=nbytes)
            self.counters["opt_fetched_bytes"] += nbytes
            # one stage ahead (§3.3.2 applied to moments): warm the next
            # expected arrivals while this stage's update computes
            pos = self._pos[stage]
            for nxt in reuse_horizon(self._order[pos + 1:],
                                     depth=PREFETCH_DEPTH):
                ntx = self._mom_tx.get(nxt)
                if ntx is not None:
                    ntx.prefetch(0)
            new, lease, blob = self.spool.host_layout(old)
        dev = self._device
        changed = torch.zeros((), dtype=torch.bool, device=dev)
        with obs.span("engine.opt_update", cat="engine", step=step,
                      stage=stage):
            for j in range(n):
                groups = [p_leaves[j], gleaves[j]]
                if self._has_m:
                    groups += [old[j], new[j]]
                if self._has_n:
                    groups += [old[n + j], new[n + j]]
                for sl in zip(*(_slices(t) for t in groups)):
                    p, g = sl[0], sl[1]
                    m = sl[2].to(dev, non_blocking=True) \
                        if self._has_m else None
                    v = sl[4].to(dev, non_blocking=True) \
                        if self._has_n else None
                    new_p, new_m, new_v = self._leaf_fn(p, m, v, g, new_step)
                    p.copy_(new_p)
                    if self._has_m:
                        changed |= _bits_differ(new_m, m)
                        sl[3].copy_(new_m, non_blocking=True)
                    if self._has_n:
                        changed |= _bits_differ(new_v, v)
                        sl[5].copy_(new_v, non_blocking=True)
            # the copies in and out of the leases have landed
            self._sync()
        self.counters["opt_updates"] += 1
        if not self._has_m:
            return
        nbytes = sum(t.numel() * t.element_size() for t in new)
        if not bool(changed):
            # write-back policy: the lease already held is bitwise the
            # same; keep it instead of rewriting the spool
            lease.release()
            self.spool.stats.opt_skipped_bytes += nbytes
            self.counters["opt_stage_skips"] += 1
            self.counters["opt_skipped_bytes"] += nbytes
            obs.instant("opt.stage_skip", cat="opt", step=step,
                        stage=stage, bytes=nbytes)
            return
        lease_id = self._lease_id(new_step, stage)
        with obs.span("opt.stage", cat="opt", step=step, stage=stage,
                      key=lease_id) as sp:
            ntx = self.spool.step(lease_id)
            ntx.offload_staged(0, new, lease, blob, device=dev)
            sp.set(bytes=nbytes)
        self.counters["opt_staged_bytes"] += nbytes
        old_tx, self._mom_tx[stage] = self._mom_tx[stage], ntx
        del old
        old_tx.close()

    def finish_step(self, params, grads):
        """Join the side stream, update the rest of the tree with the
        same kernel (in place), and return `(params, OptState(step + 1,
        None, None))`: the moments stay on the spool and in the
        bridge."""
        with obs.span("engine.opt_join", cat="engine", step=self._step):
            if self.eager:
                deadline = (threading.TIMEOUT_MAX if self.join_timeout
                            is None else self.join_timeout)
                with self._cv:
                    ok = self._cv.wait_for(
                        lambda: not self._pending or self._error,
                        timeout=deadline)
                    if not ok:
                        missing = sorted(self._pending)
                        raise RuntimeError(
                            f"opt overlap join timed out after "
                            f"{self.join_timeout:.0f}s; stages never "
                            f"tapped: {missing}")
            else:
                while self._pending and self._error is None:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        missing = sorted(self._pending)
                        raise RuntimeError(
                            f"grad taps missing for stages {missing} — "
                            f"did backward run with the opt sink?"
                        ) from None
                    try:
                        self._process(*item)
                    except BaseException as e:
                        self._error = e
                    finally:
                        self._pending.discard(item[1])
            if self._stream is not None:
                torch.cuda.current_stream(self._device).wait_stream(
                    self._stream)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "eager optimizer update failed mid-backward") from err

        new_step = self._step + 1
        rest_p = tree_flatten(_rest(params))[0]
        rest_g = tree_flatten(_rest(grads))[0]
        rest_m = (tree_flatten(self._rest_m)[0] if self._has_m
                  else [None] * len(rest_p))
        rest_n = (tree_flatten(self._rest_n)[0] if self._has_n
                  else [None] * len(rest_p))
        for leaves in zip(rest_p, rest_g, rest_m, rest_n):
            group = [t for t in leaves if t is not None]
            for sl in zip(*(_slices(t) for t in group)):
                it = iter(sl)
                p, g = next(it), next(it)
                m = next(it) if self._has_m else None
                v = next(it) if self._has_n else None
                new_p, new_m, new_v = self._leaf_fn(p, m, v, g, new_step)
                if m is not None:
                    m.copy_(new_m)
                if v is not None:
                    v.copy_(new_v)
                p.copy_(new_p)
        self._step = new_step
        return params, OptState(new_step, None, None)

    # ------------------------------------------------- materialization

    def materialize(self) -> OptState:
        """The full OptState (step, mu, nu), reassembled without consuming
        the spool leases: the layers' moments on the host, the rest of
        the tree's where they live. For checkpoints and the end of a
        run."""
        if not self._has_m:
            return OptState(self._step, None, None)
        for tx in self._mom_tx.values():    # the reads run side by side
            tx.prefetch(0)
        mu: dict = dict(self._rest_m)
        nu: dict = dict(self._rest_n) if self._has_n else None
        for tree_key, _ in _SCAN_KEYS:
            segs_m, segs_n = [], []
            si = 0
            while (tree_key, si) in self._seg_meta:
                treedef, n = self._seg_meta[(tree_key, si)]
                stage_of = {l_i: s for s, (k, s_i, l_i)
                            in self._layout.items()
                            if k == tree_key and s_i == si}
                payloads = [self._mom_tx[stage_of[li]].peek(
                    0, to_device=False) for li in range(n)]
                nl = len(payloads[0]) // (2 if self._has_n else 1)
                segs_m.append(_unflatten_stacked(treedef, payloads, 0, nl))
                if self._has_n:
                    segs_n.append(_unflatten_stacked(treedef, payloads, nl,
                                                     nl))
                si += 1
            if segs_m:
                mu[tree_key] = segs_m
                if self._has_n:
                    nu[tree_key] = segs_n
        return OptState(self._step, mu, nu)

    def moment_bytes(self) -> int:
        """Bytes of the seeded per-stage moment payloads: the write
        traffic one step's stage-back adds to the spool (an
        `AdaptivePolicy(opt_bytes_per_step=...)` prices it). 0 before
        seeding and for plain sgd."""
        return self._moment_bytes

    def stats(self) -> Dict[str, int]:
        return dict(self.counters)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None
        self._sync()
        for tx in self._mom_tx.values():
            tx.close()
        self._mom_tx = {}


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 0-d bool on a's device: do a and b differ in any bit (float32
    moments compared as int32, so -0.0 and NaN payloads count)?"""
    return torch.ne(a.view(torch.int32), b.view(torch.int32)).any()


def _unflatten_stacked(treedef, payloads, start, count):
    """One segment's tree of leaves stacked over its layers from the
    per-layer payloads' leaves start..start+count (host copies)."""
    return tree_unflatten(treedef, [
        torch.stack([p[start + j] for p in payloads])
        for j in range(count)])


__all__ = ["OptBridge", "DEFAULT_JOIN_TIMEOUT_S"]
