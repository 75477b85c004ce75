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
  * a finite loader that runs dry ends the loop cleanly.

Each step's time is taken after a synchronize of the card (the JAX loop
blocks on the new parameters); the `engine.step` span is the step
function's own (the staged engine records it). Host offload of the optimizer state and the optimizer overlap
bridge are not ported yet and are refused.
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
from repro_torch.core.tree import tree_flatten

_NOT_PORTED = "is not ported yet (ROADMAP §1 item 9)"


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
        return int((torch.as_tensor(batch["labels"]) >= 0).sum())
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
                 host_offload: Any = "none",
                 opt_bridge: Any = None,
                 on_step: Optional[Callable[[int, float, Any, Any],
                                            None]] = None,
                 install_signal_handlers: bool = False):
        if host_offload is True or host_offload not in (False, "none"):
            raise NotImplementedError(
                f"host_offload={host_offload!r} {_NOT_PORTED}")
        if opt_bridge is not None:
            raise NotImplementedError(f"opt_bridge {_NOT_PORTED}")
        self.step_fn = step_fn
        self.state = init_state
        self.loader = loader
        self.ckpt = (CheckpointManager(ckpt_dir, keep_last=keep_last)
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

    def _save(self, final: bool = False):
        if self.ckpt is not None:
            save_train_state(self.ckpt, self.state.step, self.state.params,
                             self.state.opt_state, self.loader, final=final)

    def resume(self) -> bool:
        """Restore the latest checkpoint if present, in place into the
        current state's tensors. Returns True if restored."""
        if self.ckpt is None:
            return False
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
                self.state.params, self.state.opt_state, batch)
            _block_on(params)
            dt = time.perf_counter() - t0
            self.state = TrainState(self.state.step + 1, params, opt_state)
            self.watchdog.record(self.state.step, dt)
            self._log(metrics, dt, batch)
            if self.on_step:
                self.on_step(self.state.step, dt, metrics, batch)
            if self.ckpt_every and self.state.step % self.ckpt_every == 0:
                self._save()
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
        """Metrics file closed, the checkpoint writer joined, and signal
        handlers the loop installed put back."""
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers = {}
        if self.ckpt is not None:
            self.ckpt.wait()


__all__ = ["TrainLoop", "TrainState", "StragglerWatchdog", "batch_tokens"]
