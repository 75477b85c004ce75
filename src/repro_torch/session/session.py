"""TrainSession of the port: one front door for training, after the JAX
package's `repro/session/session.py`, staged engine only.

It owns config resolution, the placement policy, the spool (built from
one `SpoolIoConfig`), the data loader (the synthetic one unless the
caller passes `loader=`, any iterable of batches; a T5 batch carries
`enc_tokens` beside `tokens` and `labels`), the optimizer, checkpoints,
tracing and the metrics JSONL (the `StepReport` schema, with per-step
spool deltas, the `resilience_*` block (and the `cache_*` block over a
managed backend) and, when traced, the step's `obs_*` overlap
analysis):

    with TrainSession("small-gpt", device="cpu", policy="spool",
                      ckpt_dir="ckpt", trace="trace.json") as s:
        result = s.run(5)
    print(result.final_loss)

The staged engine's steps run through `TrainLoop` (the one engine of
the port behind the JAX package's fault-tolerant loop): checkpoints
every `ckpt_every` steps and at the end of `run` when `ckpt_dir` is
given (none otherwise, where the JAX staged session writes a final one
into a temp dir), `run(..., resume=True)`, the straggler watchdog and,
with `install_signal_handlers`, a final checkpoint on SIGTERM/SIGINT.
`trace=` enables the process tracer (unless one is enabled already)
and writes the Chrome/Perfetto trace on `close()`.

Runs on the card (`device="cuda"`, the default) unless the caller asks
for the CPU; without CUDA it raises rather than fall back. The jit
engine and meshes are not ported yet and are refused.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from repro_torch import obs
from repro_torch.configs import ModelConfig, SpoolIoConfig, resolve_config
from repro_torch.core.engine import StagedEngine
from repro_torch.core.policies import OffloadPolicy
from repro_torch.core.report import StepReport
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import ShardedLoader, SyntheticMarkovLM
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.optim.optimizers import Optimizer, adamw, sgd
from repro_torch.resilience import unwrap_chain
from repro_torch.runtime.trainer import TrainLoop, TrainState, batch_tokens

_NOT_PORTED = "is not ported yet (ROADMAP §1)"


def resolve_optimizer(optimizer: Union[str, Optimizer], lr: float,
                      clip_norm: Optional[float] = None) -> Optimizer:
    """"adamw" | "sgd" | an Optimizer. clip_norm None keeps each
    optimizer's default (adamw 1.0, sgd off); 0 disables clipping."""
    if isinstance(optimizer, Optimizer):
        return optimizer
    if optimizer == "adamw":
        return adamw(lr) if clip_norm is None else adamw(
            lr, clip_norm=clip_norm or None)
    if optimizer == "sgd":
        return sgd(lr, clip_norm=clip_norm or None)
    raise ValueError(f"unknown optimizer {optimizer!r}")


class _Microbatches:
    """The loader as the loop sees it: each item is the list of one
    step's micro-batches. It has the loader's `state_dict` /
    `load_state_dict` (the checkpoint's data cursor) when the loader
    has them."""

    def __init__(self, loader, n: int):
        self.loader, self.n, self._it = loader, n, None
        if hasattr(loader, "state_dict"):
            self.state_dict = loader.state_dict
            self.load_state_dict = loader.load_state_dict

    def __iter__(self):
        return self

    def __next__(self) -> List[Dict]:
        if self._it is None:
            self._it = iter(self.loader)
        return [next(self._it) for _ in range(self.n)]


@dataclass
class SessionResult:
    """What a `TrainSession.run` hands back."""
    params: Any
    reports: List[StepReport] = field(default_factory=list)

    @property
    def losses(self) -> List[float]:
        return [r.loss for r in self.reports]

    @property
    def final_loss(self) -> float:
        return self.reports[-1].loss if self.reports else float("nan")


class TrainSession:
    def __init__(self, arch: Union[str, ModelConfig] = "small-gpt", *,
                 engine: str = "staged",
                 policy: Union[OffloadPolicy, str, None] = None,
                 io: Optional[SpoolIoConfig] = None,
                 optimizer: Union[str, Optimizer] = "adamw",
                 lr: float = 3e-4, batch_size: int = 8, seq_len: int = 256,
                 seed: int = 0, microbatches: int = 1,
                 device: str = "cuda", attn_impl: Optional[str] = None,
                 loader: Optional[Iterable[Dict]] = None,
                 metrics_path: Optional[str] = None,
                 min_offload_elements: Optional[int] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep_last: int = 3,
                 trace: Optional[str] = None, trace_ring: int = 0,
                 install_signal_handlers: bool = False):
        if engine != "staged":
            raise NotImplementedError(f"engine {engine!r} {_NOT_PORTED}: "
                                      "the port trains with the staged "
                                      "engine")
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is "
                               "not available (pass device='cpu' to run "
                               "on the CPU)")
        self.cfg = (resolve_config(arch) if isinstance(arch, str)
                    else arch.validate())
        self.device = device
        self.api = build_model(self.cfg)
        self.optimizer = resolve_optimizer(optimizer, lr)
        self.seed = seed
        self.microbatches = microbatches
        self.metrics_path = metrics_path
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.install_signal_handlers = install_signal_handlers
        self.settings = RunSettings(
            attn_impl=attn_impl or ("torch" if device == "cpu" else "cuda"),
            attn_chunk=256, param_dtype=self.cfg.dtype, device=device)
        self.engine = StagedEngine(
            self.api, self.settings, self.optimizer, policy=policy,
            io_config=io, min_offload_elements=min_offload_elements)
        self.policy = self.engine.policy
        self.spool = self.engine.spool
        # the synthetic loader is the session's to close; a caller's is not
        self._own_loader = None
        if loader is None:
            loader = self._own_loader = ShardedLoader(
                SyntheticMarkovLM(self.cfg.vocab_size, seed=seed),
                global_batch=batch_size, seq_len=seq_len)
        self.loader = loader
        self._batches = _Microbatches(loader, microbatches)
        self.reports: List[StepReport] = []
        self.params = None
        self.opt_state = None
        self._step = 0
        self._loop: Optional[TrainLoop] = None
        self._rep: Optional[StepReport] = None
        self._metrics_f = None
        self._stats_snapshot = None
        self._closed = False
        # the process tracer, enabled last so that a failed construction
        # leaves none behind; the session tears it down only if it
        # installed it. The cursor and counters make each step's window
        self.trace_path = trace
        self._owns_tracer = False
        self._tracer = None
        if trace is not None or trace_ring:
            self._owns_tracer = not obs.is_enabled()
            self._tracer = obs.enable(trace_ring or obs.DEFAULT_RING_SIZE)
        self._obs_cursor = None
        self._counters_snapshot: Dict[str, float] = {}
        self._cache_snapshot = None
        self._resil_snapshot: Dict[str, Any] = {}

    def init(self):
        """Random weights from a generator seeded with `seed` on the
        session's device, and the optimizer state."""
        if self.params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = self.api.init(gen)
            self.opt_state = self.optimizer.init(self.params)
        return self.params

    @property
    def n_params(self) -> int:
        return sum(t.numel() for t in tree_flatten(self.init())[0])

    @property
    def step(self) -> int:
        """Optimizer steps taken (restored ones included)."""
        return self._step

    @property
    def ckpt(self):
        """The loop's CheckpointManager (None without a ckpt_dir, or
        before the first `run`)."""
        return self._loop.ckpt if self._loop is not None else None

    @property
    def preempted(self) -> bool:
        """A SIGTERM / SIGINT (or `request_preemption`) stopped a run."""
        return self._loop is not None and self._loop.preempted

    def request_preemption(self) -> None:
        """What SIGTERM does: stop at the next step boundary, with the
        final checkpoint."""
        self._make_loop().request_preemption()

    def _step_fn(self, params, opt_state, batches):
        params, opt_state, rep = self.engine.train_step(params, opt_state,
                                                        batches)
        self._rep = rep
        return params, opt_state, {"loss": rep.loss}

    def _make_loop(self) -> TrainLoop:
        if self._loop is None:
            self._loop = TrainLoop(
                step_fn=self._step_fn,
                init_state=TrainState(self._step, self.params,
                                      self.opt_state),
                loader=self._batches, ckpt_dir=self.ckpt_dir,
                ckpt_every=self.ckpt_every, keep_last=self.keep_last,
                install_signal_handlers=self.install_signal_handlers)
        return self._loop

    def run(self, num_steps: int, *, resume: bool = False,
            on_report: Optional[Callable[[StepReport], None]] = None
            ) -> SessionResult:
        """Train `num_steps` optimizer steps (after restoring the latest
        checkpoint of `ckpt_dir` if `resume`); the reports of this run."""
        if self._closed:
            raise RuntimeError("session is closed")
        self.init()
        start = len(self.reports)

        def on_step(step, dt, metrics, batches):
            rep, self._rep = self._rep, None
            rep.step = step
            rep.stats, rep.obs = self._step_deltas()
            rep.cache, rep.resilience = self._storage_deltas()
            tokens = sum(batch_tokens(b) for b in batches)
            rep.tokens_per_s = tokens / rep.step_time if rep.step_time \
                else 0.0
            self._emit(rep, on_report)

        if resume and self.ckpt_dir is None:
            raise ValueError("resume=True needs a ckpt_dir")
        loop = self._make_loop()
        loop.on_step = on_step
        loop.state = TrainState(self._step, self.params, self.opt_state)
        if resume and loop.resume():
            # restored in place: the session's tensors hold the step
            self._step, self.params, self.opt_state = (
                loop.state.step, loop.state.params, loop.state.opt_state)
        state = loop.run(num_steps)
        self._step, self.params, self.opt_state = (
            state.step, state.params, state.opt_state)
        return SessionResult(self.params, list(self.reports[start:]))

    def _step_deltas(self):
        """The step's spool stats delta and, when a tracer is enabled,
        the overlap analysis of the step's trace window."""
        cur = self.spool.stats.snapshot()
        prev = self._stats_snapshot
        stats = cur.sub(prev) if prev is not None else cur
        self._stats_snapshot = cur
        tracer = obs.get_tracer()
        if tracer is None:
            return stats, None
        from repro_torch.obs import overlap
        events, self._obs_cursor = tracer.snapshot_new(self._obs_cursor)
        counters = tracer.counters()
        prev_c = self._counters_snapshot
        self._counters_snapshot = counters
        return stats, overlap.analyze(
            events, {k: v - prev_c.get(k, 0) for k, v in counters.items()})

    def _storage_deltas(self):
        """The step's cache-manager block (managed backends only) and
        resilience block, as the JAX session computes them: the deltas
        of the retry, fallback, re-plan and rebalance counters, plus the
        backend's health and devices-down gauges."""
        cm = self.spool.cache_manager
        cache = None
        if cm is not None:
            cache, self._cache_snapshot = cm.metrics_delta(
                self._cache_snapshot)
        st = self.spool.stats
        cur = {"store_retries": st.store_retries,
               "load_retries": st.load_retries,
               "fetch_fallbacks": st.fetch_fallbacks}
        if hasattr(self.policy, "replans"):
            cur["replans"] = self.policy.replans
        chain = list(unwrap_chain(self.spool.backend))
        striped = next((b for b in chain
                        if hasattr(b, "rebalanced_chunks")), None)
        if striped is not None:
            cur["rebalanced_chunks"] = striped.rebalanced_chunks
            cur["chunk_write_failures"] = striped.chunk_write_failures
        prev = self._resil_snapshot
        resilience = {k: v - prev.get(k, 0) for k, v in cur.items()}
        self._resil_snapshot = cur
        resilience["health"] = self.spool.health.snapshot()["health"]
        if striped is not None:
            resilience["devices_down"] = sum(striped.devices_down())
        return cache, resilience

    def _emit(self, rep: StepReport, on_report) -> None:
        self.reports.append(rep)
        if self.metrics_path:
            if self._metrics_f is None:
                self._metrics_f = open(self.metrics_path, "a")
            self._metrics_f.write(json.dumps(rep.to_metrics()) + "\n")
            self._metrics_f.flush()
        if on_report:
            on_report(rep)

    def close(self) -> None:
        """Idempotent teardown: engine and spool (workers joined, owned
        temp dir removed), the loop (checkpoint writer joined, signal
        handlers put back), the synthetic loader, metrics file; then the
        trace is written, every span closed."""
        if self._closed:
            return
        self._closed = True
        self.engine.close()
        if self._loop is not None:
            self._loop.close()
        if self._own_loader is not None:
            self._own_loader.close()
        if self._metrics_f is not None:
            self._metrics_f.close()
        if self._tracer is not None and self.trace_path:
            from repro_torch.obs.export import write_chrome_trace
            write_chrome_trace(self.trace_path, self._tracer,
                               extra={"engine": "staged",
                                      "arch": self.cfg.name})
        if self._owns_tracer:
            obs.disable()

    def __enter__(self) -> "TrainSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


__all__ = ["TrainSession", "SessionResult", "resolve_optimizer",
           "batch_tokens"]
