"""TrainSession of the port: one front door for training, after the JAX
package's `repro/session/session.py`, staged engine only.

It owns config resolution, the placement policy, the spool (built from
one `SpoolIoConfig`), the data loader (the synthetic one unless the
caller passes `loader=`, any iterable of batches; a T5 batch carries
`enc_tokens` beside `tokens` and `labels`), the optimizer and the
metrics JSONL (the `StepReport` schema, with per-step spool deltas):

    with TrainSession("small-gpt", device="cpu", policy="spool") as s:
        result = s.run(5)
    print(result.final_loss)

Runs on the card (`device="cuda"`, the default) unless the caller asks
for the CPU; without CUDA it raises rather than fall back. The jit
engine, checkpoints, tracing and meshes are not ported yet and are
refused.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from repro_torch.configs import ModelConfig, SpoolIoConfig, resolve_config
from repro_torch.core.engine import StagedEngine
from repro_torch.core.policies import OffloadPolicy
from repro_torch.core.report import StepReport
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import ShardedLoader, SyntheticMarkovLM
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.optim.optimizers import Optimizer, adamw, sgd

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


def batch_tokens(batch) -> int:
    """Real target tokens of a batch (labels >= 0)."""
    return int((torch.as_tensor(batch["labels"]) >= 0).sum())


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
                 on_fetch_fail: str = "recompute"):
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
        self.settings = RunSettings(
            attn_impl=attn_impl or ("torch" if device == "cpu" else "cuda"),
            attn_chunk=256, param_dtype=self.cfg.dtype, device=device)
        self.engine = StagedEngine(
            self.api, self.settings, self.optimizer, policy=policy,
            io_config=io, min_offload_elements=min_offload_elements,
            on_fetch_fail=on_fetch_fail)
        self.policy = self.engine.policy
        self.spool = self.engine.spool
        # the synthetic loader is the session's to close; a caller's is not
        self._own_loader = None
        if loader is None:
            loader = self._own_loader = ShardedLoader(
                SyntheticMarkovLM(self.cfg.vocab_size, seed=seed),
                global_batch=batch_size, seq_len=seq_len)
        self.loader = loader
        self._loader_iter = None
        self.reports: List[StepReport] = []
        self.params = None
        self.opt_state = None
        self._metrics_f = None
        self._stats_snapshot = None
        self._closed = False

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

    def run(self, num_steps: int, *,
            on_report: Optional[Callable[[StepReport], None]] = None
            ) -> SessionResult:
        """Train `num_steps` optimizer steps; the reports of this run."""
        if self._closed:
            raise RuntimeError("session is closed")
        self.init()
        start = len(self.reports)
        if self._loader_iter is None:
            self._loader_iter = iter(self.loader)
        for _ in range(num_steps):
            batches = [next(self._loader_iter)
                       for _ in range(self.microbatches)]
            self.params, self.opt_state, rep = self.engine.train_step(
                self.params, self.opt_state, batches)
            rep.step = len(self.reports) + 1
            cur = self.spool.stats.snapshot()
            prev = self._stats_snapshot
            rep.stats = cur.sub(prev) if prev is not None else cur
            self._stats_snapshot = cur
            tokens = sum(batch_tokens(b) for b in batches)
            rep.tokens_per_s = tokens / rep.step_time if rep.step_time \
                else 0.0
            self._emit(rep, on_report)
        return SessionResult(self.params, list(self.reports[start:]))

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
        temp dir removed), the synthetic loader, metrics file."""
        if self._closed:
            return
        self._closed = True
        self.engine.close()
        if self._own_loader is not None:
            self._own_loader.close()
        if self._metrics_f is not None:
            self._metrics_f.close()

    def __enter__(self) -> "TrainSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


__all__ = ["TrainSession", "SessionResult", "resolve_optimizer",
           "batch_tokens"]
