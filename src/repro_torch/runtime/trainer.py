"""Fault-tolerant training driver of the port, after the JAX package's
`repro/runtime/trainer.py`:

  * checkpoint/restart: periodic async checkpoints (parameters,
    optimizer state, data cursor) every `ckpt_every` steps and a final
    one at the end of `run`; `resume()` picks up the latest committed
    step. One departure: with no `ckpt_dir` the loop writes no
    checkpoint at all (the JAX loop always has a directory);
  * preemption: SIGTERM/SIGINT (with `install_signal_handlers`) or
    `request_preemption()` set a flag; the loop stops at the next step
    boundary and writes its final checkpoint;
  * stragglers: a rolling-median step-time watchdog flags steps slower
    than `threshold x median`;
  * metrics: one JSONL line per step (loss, step time, tokens/s), or the
    caller's own rows through `on_step`;
  * a finite loader that runs dry ends the loop cleanly;
  * host offload (the jit engine, with a spool from the caller):
      - "opt_state": the optimizer state is staged through the spool
        between steps: offloaded asynchronously after the update
        (`engine.opt_stage`), fetched back just before the next one
        (`engine.opt_fetch`). A store still queued is cancelled and one
        still writing is not re-read: its host copy is forwarded. The
        copy back allocates the state on the card, and where the
        store's write syscalls hold the process's address space (a 9p
        mount in a sandbox, PERF.md §5) those allocations wait for them;
      - "activations": the step function's engine spools the layers'
        residuals itself; the loop only carries the spool;
    and with an `opt_bridge` (`repro_torch.optim.overlap`) the bridge
    owns the optimizer state's placement, per layer, so "opt_state"
    staging is off and the loop's state holds the bridge's light
    `(step, None, None)`;
  * meshes: a `ckpt_layout` (`core/meshrun.py::ShardLayout`) makes the
    checkpoints hold logical arrays, written by rank 0 and cut back into
    every rank's shards on resume; `lease_suffix` qualifies the staged
    state's lease (`opt{step}` + suffix, the rank's shard, e.g. `/s1`),
    since the ranks share one spool directory.

Each step's time is taken after a synchronize of the card (the JAX loop
blocks on the new parameters), the optimizer state's fetch included;
the `engine.step` span is the step function's own (the engine records
it). Two departures: with no `ckpt_dir` the loop writes no checkpoint;
with an opt bridge the state keeps the bridge's light state at the end
of `run` (the JAX loop materializes the moments into it), and a
checkpoint materializes them.
"""
from __future__ import annotations

import json
import signal
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                         restore_train_state,
                                         save_train_state)
from repro_torch import obs
from repro_torch.core.tree import tree_flatten
from repro_torch.optim.optimizers import OptState


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def batch_tokens(batch) -> int:
    """Tokens a batch contributes to throughput. With labels present
    only real targets count (labels >= 0); else the token count; 0 when
    the batch carries no tokens."""
    if isinstance(batch, dict) and "labels" in batch:
        labels = torch.as_tensor(batch["labels"])
        if labels.device.type == "meta":     # a dry run's: no values
            return labels.numel()
        return int((labels >= 0).sum())
    if isinstance(batch, dict) and "tokens" in batch:
        return int(np.prod(tuple(batch["tokens"].shape)))
    return 0


class StragglerWatchdog:
    """Rolling-median step-time monitor."""

    def __init__(self, *, window: int = 32, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.flagged: List[Dict] = []

    def record(self, step: int, dt: float) -> bool:
        history = self.times[-self.window:]
        is_straggler = False
        if len(history) >= 8:
            med = statistics.median(history)
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append({"step": step, "dt": dt, "median": med})
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler


def _or_empty(tree):
    return [] if tree is None else tree


def _opt_state(staged) -> OptState:
    """The OptState of a staged-out record [step, mu or [], nu or []]."""
    step, mu, nu = staged
    return OptState(int(step), mu if mu != [] else None,
                    nu if nu != [] else None)


def _block_on(params) -> None:
    """Wait for the card to finish the step (the parameters' device)."""
    leaf = next((t for t in tree_flatten(params)[0]
                 if isinstance(t, torch.Tensor)), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class TrainLoop:
    def __init__(self, *, step_fn: Callable, init_state: TrainState,
                 loader, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, keep_last: int = 3,
                 metrics_path: Optional[str] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 spool: Any = None,
                 host_offload: Any = "none",
                 opt_bridge: Any = None,
                 ckpt_layout: Any = None, lease_suffix: str = "",
                 on_step: Optional[Callable[[int, float, Any, Any],
                                            None]] = None,
                 install_signal_handlers: bool = False):
        # a bool is the JAX loop's legacy spelling of "opt_state"
        if isinstance(host_offload, bool):
            host_offload = "opt_state" if host_offload else "none"
        if host_offload not in ("none", "opt_state", "activations"):
            raise ValueError(f"host_offload {host_offload!r}: none | "
                             "opt_state | activations")
        # the bridge owns the optimizer state's placement per layer: the
        # whole-state staging between steps is off under it
        self.opt_bridge = opt_bridge
        if opt_bridge is not None and host_offload == "opt_state":
            host_offload = "none"
        self.spool = spool
        self.host_offload = host_offload if spool is not None else "none"
        self.lease_suffix = lease_suffix
        self._opt_tx = None          # the staged-out optimizer state
        self.step_fn = step_fn
        self.state = init_state
        self.loader = loader
        self.ckpt = (CheckpointManager(ckpt_dir, keep_last=keep_last,
                                       layout=ckpt_layout)
                     if ckpt_dir is not None else None)
        self.ckpt_every = ckpt_every
        self.metrics_path = metrics_path
        self.watchdog = watchdog or StragglerWatchdog()
        self.on_step = on_step
        self._preempted = False
        self._metrics_f = open(metrics_path, "a") if metrics_path else None
        self._old_handlers: Dict[int, Any] = {}
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._old_handlers[sig] = signal.signal(sig,
                                                        self._on_preempt)

    def _on_preempt(self, signum, frame):
        # async-signal-safe: set a flag; the loop checkpoints at the
        # next step boundary
        self._preempted = True

    def request_preemption(self):
        """Simulate the scheduler's SIGTERM."""
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    # ----------------------------------------------- host offload (jit)

    def _acquire_opt_state(self):
        """The optimizer state, fetched back from the spool if the
        previous step staged it out (a store still in flight is
        forwarded, not re-read; closing the lease deletes a landed blob
        on this thread)."""
        if self._opt_tx is None:
            return self.state.opt_state
        tx, self._opt_tx = self._opt_tx, None
        with obs.span("engine.opt_fetch", cat="engine",
                      step=self.state.step):
            state = _opt_state(tx.fetch(0))
        tx.close()                  # drops the record and its blob
        return state

    def _stage_opt_state(self, opt_state, step: int):
        """Offload the fresh optimizer state through the spool; returns
        what TrainState holds (None while it is staged out: the spool
        holds the only reference until the next acquire)."""
        if self.host_offload != "opt_state":
            return opt_state
        with obs.span("engine.opt_stage", cat="engine", step=step):
            tx = self.spool.step(f"opt{step}{self.lease_suffix}")
            # the step counter rides as a kept leaf; an absent moment
            # (sgd) is an empty list
            tx.offload(0, [torch.tensor(opt_state.step),
                           _or_empty(opt_state.mu), _or_empty(opt_state.nu)])
        self._opt_tx = tx
        return None

    def _save(self, final: bool = False):
        if self.ckpt is None:
            return
        opt_state = self.state.opt_state
        if self.opt_bridge is not None and self.opt_bridge.seeded:
            # the layers' moments live on the spool (the rest in the
            # bridge): reassembled without consuming a lease
            opt_state = self.opt_bridge.materialize()
        elif opt_state is None and self._opt_tx is not None:
            # staged out between steps: peek on the host, which must not
            # cancel the queued store the next step fetches
            opt_state = _opt_state(self._opt_tx.peek(0, to_device=False))
        save_train_state(self.ckpt, self.state.step, self.state.params,
                         opt_state, self.loader, final=final)

    def resume(self) -> bool:
        """Restore the latest checkpoint if present, in place into the
        current state's tensors. Returns True if restored."""
        if self.ckpt is None:
            return False
        if self.opt_bridge is not None and self.opt_bridge.seeded:
            raise RuntimeError(
                "resume into an optimizer overlap that holds moments "
                "already: restore in a fresh session")
        restored = restore_train_state(
            self.ckpt, self.state.params, self.state.opt_state, self.loader)
        if restored is None:
            return False
        self.state = TrainState(*restored)
        return True

    def run(self, num_steps: int) -> TrainState:
        it = iter(self.loader)
        target = self.state.step + num_steps
        while self.state.step < target and not self._preempted:
            try:
                batch = next(it)
            except StopIteration:
                # a finite loader ran dry: end cleanly, the final
                # checkpoint below still runs
                break
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(
                self.state.params, self._acquire_opt_state(), batch)
            _block_on(params)
            dt = time.perf_counter() - t0
            opt_state = self._stage_opt_state(opt_state,
                                              self.state.step + 1)
            self.state = TrainState(self.state.step + 1, params, opt_state)
            self.watchdog.record(self.state.step, dt)
            self._log(metrics, dt, batch)
            if self.on_step:
                self.on_step(self.state.step, dt, metrics, batch)
            if self.ckpt_every and self.state.step % self.ckpt_every == 0:
                self._save()
        # a staged-out optimizer state comes back before the final
        # checkpoint and the hand-back
        if self._opt_tx is not None:
            self.state = TrainState(self.state.step, self.state.params,
                                    self._acquire_opt_state())
        self._save(final=True)
        return self.state

    def _log(self, metrics, dt, batch):
        if self._metrics_f is None:
            return
        rec = {"step": self.state.step, "step_time_s": dt}
        tokens = batch_tokens(batch)
        if tokens:
            rec["tokens_per_s"] = tokens / dt
        for k, v in (metrics or {}).items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def close(self):
        """A staged-out optimizer state dropped, metrics file closed, the
        checkpoint writer joined, and signal handlers the loop installed
        put back."""
        if self._opt_tx is not None:
            self._opt_tx.close()
            self._opt_tx = None
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers = {}
        if self.ckpt is not None:
            self.ckpt.wait()


__all__ = ["TrainLoop", "TrainState", "StragglerWatchdog", "batch_tokens"]
