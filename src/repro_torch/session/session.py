"""TrainSession of the port: one front door for training, after the JAX
package's `repro/session/session.py`, both engines on one device.

It owns config resolution, the placement policy, the spool (built from
one `SpoolIoConfig`), the data loader (the synthetic one unless the
caller passes `loader=`, any iterable of batches; a T5 batch carries
`enc_tokens` beside `tokens` and `labels`, a hubert batch `embeddings`
and `labels` (`data.pipeline.embedding_batches`), a llama-3.2-vision
batch `enc_embeddings` beside `tokens` and `labels`
(`data.pipeline.vision_batches`; the synthetic loader makes tokens
only, so the last two need a loader)), the optimizer,
checkpoints,
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

`engine="jit"` is the JAX package's jit engine on the port's one
engine: the staged engine with its placement from
`settings.activation_policy` ("remat" by default, "keep", "offload" /
"offload_ssd" (the host tier: layer inputs in pinned host memory
between forward and backward), "save_names", or "spool" with
`io.host_offload="activations"`, decoder layers as
`settings.spool_stages` marks them; `policy_for_jit`), and the steps of
`repro_torch.launch.steps`. `io.host_offload="opt_state"` stages the
optimizer state through the spool between steps; `opt_overlap` (the
kwarg, else `io.opt_overlap`; True: the eager worker, "sync": the same
per-layer updates drained at the step's end) updates each layer as its
gradients land in backward, its moments on the spool
(`repro_torch.optim.overlap.OptBridge`, `opt_bridge`; its per-step
counters join the metrics rows). A profiled AdaptivePolicy drives the
jit engine through `settings=policy.plan_for_jit().apply(settings)`.

Runs on the card (`device="cuda"`, the default) unless the caller asks
for the CPU; without CUDA it raises rather than fall back.

`mesh=` (a `parallel/mesh.py::Mesh` with its `Comm`, one process per
rank: `parallel/comm.py::init_mesh`) trains on a data x model mesh, as
the JAX jit session does (`repro/session/session.py:132-166, 271-308`):
`mesh_axes` (default: every axis but "model" is dp, "model" is tp) fills
`settings.mesh / tp_axis / dp_axes`; each rank holds its shard of the
parameters (`layout_specs(fsdp=True)`, `init` cuts them from the seed's
global weights) and of the moments (ZeRO), trains on its rows of the
global batch, and with `io.host_offload="activations"` spools its layers
through the mesh hooks (`core/hooks.py`) into one directory every rank
shares (rank 0 makes it when `io.directory` is unset and removes it on
close). The metrics rows gain the `shards` block (the step's hook traffic
by shard, summed over the ranks), `comm_backend` and
`comm_host_staged_bytes`. A mesh needs the jit engine, as JAX's; every
family trains on one (dense and MoE decoders and encoders, hubert's
embeddings input, llama-3.2-vision's cross blocks, T5's two streams,
mamba2 on each rank's SSM heads and recurrentgemma's RG-LRU on each
rank's width), where the tensor axis divides those heads and that width
(`core/meshrun.py::check_mesh_config`). The parameters are laid out by
`parallel/sharding.py::layout_specs` (mamba2's concatenated leaves part
by part). Checkpoints of a mesh hold the logical arrays, gathered over the
ranks and written by rank 0, and restore onto any mesh or one device
(`core/meshrun.py::ShardLayout`); the optimizer overlap and
`io.host_offload="opt_state"` run on each rank's ZeRO-1 shards, their
leases qualified by the rank (`/s{rank}`) in the shared directory.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from repro_torch import obs
from repro_torch.configs import ModelConfig, SpoolIoConfig, resolve_config
from repro_torch.core.engine import StagedEngine, layer_stage_names
from repro_torch.core.meshrun import (ShardLayout, check_mesh_config,
                                     shard_tree)
from repro_torch.core.policies import OffloadPolicy, policy_for_jit
from repro_torch.core.report import StepReport
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import ShardedLoader, SyntheticMarkovLM
from repro_torch.launch.steps import (make_host_train_step,
                                      make_overlap_train_step)
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.optim.optimizers import Optimizer, OptState, adamw, sgd
from repro_torch.optim.overlap import OptBridge
from repro_torch.parallel.comm import rank_device
from repro_torch.parallel.sharding import default_axes, layout_specs
from repro_torch.resilience import unwrap_chain
from repro_torch.runtime.trainer import TrainLoop, TrainState, batch_tokens

ENGINES = ("staged", "jit")


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
                 settings: Optional[RunSettings] = None,
                 opt_overlap: Union[bool, str, None] = None,
                 mesh: Any = None, mesh_axes: Any = None,
                 install_signal_handlers: bool = False):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"expected one of {ENGINES}")
        if engine == "jit" and policy is not None:
            raise ValueError(
                "OffloadPolicy applies to the staged engine; the jit "
                "engine takes its activation placement from "
                "RunSettings.activation_policy and uses "
                "io.host_offload ('opt_state' between-step staging or "
                "'activations' per-layer spooling). To drive the jit "
                "engine from a profiled AdaptivePolicy, pass "
                "settings=policy.plan_for_jit().apply(settings)")
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is "
                               "not available (pass device='cpu' to run "
                               "on the CPU)")
        if settings is not None and settings.device != device:
            raise ValueError(f"settings.device {settings.device!r} is not "
                             f"the session's device {device!r}")
        self.cfg = (resolve_config(arch) if isinstance(arch, str)
                    else arch.validate())
        self.mesh, self.mesh_axes = mesh, None
        self._own_shared_dir = None
        if mesh is not None:
            io = self._init_mesh(engine, io, mesh_axes, device)
        if loader is None and self.cfg.input_kind != "tokens":
            raise ValueError(
                f"{self.cfg.name} takes {self.cfg.input_kind} inputs and "
                f"the synthetic data makes tokens only: pass loader=, an "
                f"iterable of batches of {{'{self.cfg.input_kind}', "
                f"'labels'}} (data.pipeline.embedding_batches)")
        if loader is None and self.cfg.family == "vlm":
            raise ValueError(
                f"{self.cfg.name} reads enc_embeddings beside its tokens "
                f"and the synthetic data makes tokens only: pass loader=, "
                f"an iterable of batches of {{'tokens', 'labels', "
                f"'enc_embeddings'}} (data.pipeline.vision_batches)")
        self.io = io.validate() if io is not None else None
        # the optimizer overlap: the kwarg wins, else the io config's
        # knob. True runs the worker; "sync" the same per-layer updates
        # at the step's end (the serial schedule of the same kernels)
        if opt_overlap is None:
            opt_overlap = self.io.opt_overlap if self.io is not None \
                else False
        if opt_overlap not in (False, True, "sync"):
            raise ValueError(f"opt_overlap {opt_overlap!r}: False | True "
                             "| 'sync'")
        if opt_overlap and engine != "jit":
            raise ValueError("opt_overlap is a jit-engine feature (the "
                             "staged engine already updates per stage)")
        self.engine_name = engine
        self.opt_overlap = opt_overlap
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
        base = RunSettings(
            attn_impl=attn_impl or ("torch" if device == "cpu" else "cuda"),
            attn_chunk=256, param_dtype=self.cfg.dtype, device=device)
        if mesh is not None:
            base = self._with_mesh(base)
            if settings is not None:
                settings = self._with_mesh(settings)
        self.opt_bridge: Optional[OptBridge] = None
        self._optb_snapshot: Dict[str, int] = {}
        if engine == "staged":
            self.settings = settings or base
            self.engine = StagedEngine(
                self.api, self.settings, self.optimizer, policy=policy,
                io_config=self.io,
                min_offload_elements=min_offload_elements)
            self.policy = self.engine.policy
            self.spool = self.engine.spool
            self.host_offload = "none"
            self._step_fn = make_host_train_step(self.engine)
        else:
            self._init_jit(base, settings, min_offload_elements)
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
        self._shard_snapshot: Dict[str, Dict[str, int]] = {}

    def _init_mesh(self, engine, io, mesh_axes, device):
        """Check a mesh run, pick the axes' roles and share one spool
        directory between the ranks. Returns the io config to use."""
        if engine != "jit":
            raise ValueError(
                "mesh-sharded training is a jit-engine feature; the "
                "staged engine runs one device")
        self.mesh_axes = mesh_axes or default_axes(self.mesh)
        check_mesh_config(self.cfg, self.mesh, self.mesh_axes)
        if self.mesh.comm is None:
            raise ValueError("the mesh has no Comm: build it with "
                             "parallel.comm.init_mesh")
        if device != "cpu":
            torch.cuda.set_device(torch.device(rank_device("cuda")))
        if io is not None and io.directory is None:
            # one directory every rank sees: the primary replica's blobs
            # are read by the others
            d = (tempfile.mkdtemp(prefix="repro_torch_mesh_spool_")
                 if self.mesh.rank == 0 else None)
            d = self.mesh.comm.gather_objects(d)[0]
            if self.mesh.rank == 0:
                self._own_shared_dir = d
            io = dataclasses.replace(io, directory=d)
        return io

    def _lease_suffix(self) -> str:
        """What qualifies the optimizer state's leases in the directory
        the ranks share: this rank's shard (its linear index over every
        axis, its rank)."""
        return "" if self.mesh is None else f"/s{self.mesh.rank}"

    def _with_mesh(self, settings: RunSettings) -> RunSettings:
        return dataclasses.replace(settings, mesh=self.mesh,
                                   tp_axis=self.mesh_axes.tp,
                                   dp_axes=self.mesh_axes.dp)

    def _init_jit(self, base, settings, min_offload_elements) -> None:
        """The jit engine: the engine with the placement the settings
        name, the serial or the overlap step, and the spool reported (as
        the JAX session builds one) when the optimizer state or the
        activations go through it."""
        mode = self.io.host_offload if self.io is not None else "none"
        if mode == "activations" and settings is not None \
                and settings.activation_policy != "spool":
            raise ValueError(
                "io.host_offload='activations' requires "
                "settings.activation_policy='spool' (got "
                f"{settings.activation_policy!r}); either drop the "
                "'activations' mode or let the session synthesize "
                "the settings. A JitOffloadPlan that kept every "
                "layer on device (activation_policy='keep') needs "
                "no spool — run without host_offload='activations'")
        self.settings = settings or dataclasses.replace(
            base, activation_policy=("spool" if mode == "activations"
                                     else "remat"))
        self.engine = StagedEngine(
            self.api, self.settings, self.optimizer,
            policy=policy_for_jit(self.settings,
                                  layer_stage_names(self.api)),
            io_config=self.io, min_offload_elements=min_offload_elements,
            engine_name="jit")
        self.policy = None
        self.host_offload = mode
        self.spool = (self.engine.spool
                      if mode != "none" or self.opt_overlap else None)
        if self.opt_overlap:
            self.opt_bridge = OptBridge(
                self.optimizer, self.engine.spool,
                eager=self.opt_overlap != "sync",
                lease_suffix=self._lease_suffix())
            self.settings = dataclasses.replace(self.settings,
                                                opt_sink=self.opt_bridge)
            self.engine.settings = self.settings
            self._step_fn = make_overlap_train_step(self.engine,
                                                    self.opt_bridge)
        else:
            self._step_fn = make_host_train_step(self.engine)

    def init(self):
        """Random weights from a generator seeded with `seed` on the
        session's device, and the optimizer state."""
        if self.params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = self.api.init(gen)
            if self.mesh is not None:
                # this rank's shards (the moments follow: ZeRO)
                specs = layout_specs(self.cfg, params, self.mesh,
                                     self.mesh_axes, fsdp=True)
                self.engine.mesh_run.set_specs(specs)
                params = shard_tree(params, specs, self.mesh)
            self.params = params
            self.opt_state = self.optimizer.init(self.params)
        return self.params

    def set_params(self, params) -> None:
        """Start from these global weights, a tree of numpy arrays (the
        JAX package's, `jax.tree.map(np.asarray, ...)`) in place of the
        seed's: on a mesh this rank's shards of them
        (`models/convert.py::shard_params_from_jax`). The optimizer state
        starts anew."""
        from repro_torch.models.convert import (params_from_jax,
                                                shard_params_from_jax)
        if self.mesh is not None:
            specs = layout_specs(self.cfg, params, self.mesh,
                                 self.mesh_axes, fsdp=True)
            self.engine.mesh_run.set_specs(specs)
            self.params = shard_params_from_jax(params, specs, self.mesh,
                                                device=self.device)
        else:
            self.params = params_from_jax(params, device=self.device)
        self.opt_state = self.optimizer.init(self.params)

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

    def _make_loop(self) -> TrainLoop:
        if self._loop is None:
            self._loop = TrainLoop(
                step_fn=self._step_fn,
                init_state=TrainState(self._step, self.params,
                                      self.opt_state),
                loader=self._batches, ckpt_dir=self.ckpt_dir,
                ckpt_every=self.ckpt_every, keep_last=self.keep_last,
                spool=self.engine.spool, host_offload=self.host_offload,
                opt_bridge=self.opt_bridge,
                ckpt_layout=(ShardLayout(self.mesh,
                                         self.engine.mesh_run.specs,
                                         self.settings.device)
                             if self.mesh is not None
                             and self.ckpt_dir is not None else None),
                lease_suffix=self._lease_suffix(),
                install_signal_handlers=self.install_signal_handlers)
        return self._loop

    def _jit_report(self, step, dt, metrics) -> StepReport:
        """The JAX jit session's row: the step's metrics (`ce`, `tokens`,
        `loss`), the bridge's counter deltas, on the card the engine's
        device peak, and under a tier of names inside a layer the bytes
        it held (`named_bytes`)."""
        rep = metrics["report"]
        extra = {}
        for k, v in metrics.items():
            try:
                extra[k] = float(v)
            except (TypeError, ValueError):
                pass
        if self.opt_bridge is not None:
            cur = self.opt_bridge.stats()
            prev = self._optb_snapshot
            extra.update({k: cur[k] - prev.get(k, 0) for k in cur})
            self._optb_snapshot = cur
        for k, v in rep.extra.items():
            if k in ("device_peak_bytes", "named_bytes") \
                    or k.startswith("comm_"):
                extra[k] = v
        return StepReport(
            loss=extra["loss"], step_time=dt,
            peak_activation_bytes=rep.peak_activation_bytes,
            backward_begin_bytes=rep.backward_begin_bytes, step=step,
            engine="jit", extra=extra)

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
            rep = (self._jit_report(step, dt, metrics)
                   if self.engine_name == "jit" else metrics["report"])
            rep.step = step
            rep.stats, rep.obs = self._step_deltas()
            if self.mesh is not None:
                rep.shard_stats = self._shard_deltas()
                rep.extra["comm_backend"] = self.mesh.comm.backend
            if self.spool is not None:
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
        if self.opt_bridge is not None and not self.opt_bridge.seeded:
            # the bridge takes the moments over now, so the card holds
            # the full state no longer than it takes to stage it out
            self.opt_bridge.seed(self.opt_state, self.params)
            self.opt_state = OptState(self.opt_state.step, None, None)
            loop.state = TrainState(self._step, self.params,
                                    self.opt_state)
        # while the loop runs its state is the one reference: a state
        # staged out between steps leaves the card, and the next step's
        # fetch is its only copy there
        self.opt_state = None
        try:
            loop.run(num_steps)
        finally:
            self._step, self.params, self.opt_state = (
                loop.state.step, loop.state.params, loop.state.opt_state)
        return SessionResult(self.params, list(self.reports[start:]))

    def _step_deltas(self):
        """The step's spool stats delta (None without a spool, as the
        JAX jit session has none) and, when a tracer is enabled, the
        overlap analysis of the step's trace window."""
        stats = None
        if self.spool is not None:
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

    def _shard_deltas(self) -> Dict[str, Dict[str, int]]:
        """The step's mesh-hook traffic by shard id, summed over the ranks
        (each rank counts its own calls): a collective every rank makes
        at each step's end."""
        bridge = self.engine.mesh_run.bridge
        mine = bridge.stats_by_shard() if bridge is not None else {}
        cur: Dict[str, Dict[str, int]] = {}
        for rank_stats in self.mesh.comm.gather_objects(mine):
            for shard, rec in rank_stats.items():
                tot = cur.setdefault(str(shard), dict.fromkeys(rec, 0))
                for k, v in rec.items():
                    tot[k] += v
        prev, self._shard_snapshot = self._shard_snapshot, cur
        out = {}
        for shard, rec in cur.items():
            d = {k: v - prev.get(shard, {}).get(k, 0)
                 for k, v in rec.items()}
            if any(d.values()):
                out[shard] = d
        return out

    def shard_totals(self) -> Dict[str, Dict[str, int]]:
        """The run's mesh-hook traffic by shard, summed over the ranks
        (as of the last step)."""
        return {k: dict(v) for k, v in self._shard_snapshot.items()}

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
        if self._loop is not None:
            self._loop.close()          # drops a staged-out opt state
        if self.opt_bridge is not None:
            self.opt_bridge.close()     # stops the worker, drops leases
        self.engine.close()
        if self.mesh is not None:
            # every rank's spool is closed before the shared dir goes
            self.mesh.comm.barrier()
            if self._own_shared_dir is not None:
                shutil.rmtree(self._own_shared_dir, ignore_errors=True)
        if self._own_loader is not None:
            self._own_loader.close()
        if self._metrics_f is not None:
            self._metrics_f.close()
        if self._tracer is not None and self.trace_path:
            from repro_torch.obs.export import write_chrome_trace
            write_chrome_trace(self.trace_path, self._tracer,
                               extra={"engine": self.engine_name,
                                      "arch": self.cfg.name})
        if self._owns_tracer:
            obs.disable()

    def __enter__(self) -> "TrainSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


__all__ = ["ENGINES", "TrainSession", "SessionResult", "resolve_optimizer",
           "batch_tokens"]
