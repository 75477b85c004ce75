"""Step builders, after the JAX package's `repro/launch/steps.py`: the two
host train steps of the jit engine, and the builders the dry run, the
smoke run and a caller timing one step share.

`make_host_train_step` / `make_overlap_train_step` return what
`TrainLoop` drives: `(params, opt_state, batches) -> (params, opt_state,
metrics)`, `batches` being one step's list of micro-batches. The port's
jit engine is the staged engine (`core/engine.py`) with its placement
from `RunSettings.activation_policy`, so a step is `engine.train_step`.
The metrics are the JAX step's (`ce`, `tokens`, `loss`, and `moe_lb` /
`moe_z` for an MoE model) plus the engine's `StepReport` under `report`
(not a number, so the loop's JSONL and the session's rows skip it).

`make_train_step`, `make_prefill_step`, `make_decode_step` and
`make_step` return a `StepBundle`: `fn(*args)` runs one step, and `args`
are tensors on the device the caller names: "meta" for the dry run
(shapes only: the engine counts its offloads and keeps the tensors),
"cuda" on the card (random weights and inputs from `seed`), "cpu". The
train step drives the engine under `build_settings`' placement ("offload"
with `offload_names=("blk_in",)`: the host tier). On a mesh the
parameters and the optimizer state are this rank's shards
(`parallel/sharding.py::layout_specs(fsdp=True)`, `local_shape`); the
batch is the global one, of which the engine takes this rank's rows as
it does from a loader. The moments follow the parameters' layout, as
JAX's inherit the parameters' specs; the port's ZeRO-1 is that layout
(mamba2's leaves by part), not a reshard of the moments.

The prefill and decode builders serve on a mesh as JAX's do under GSPMD:
the weights TP-only (`layout_specs(fsdp=False)`) while a rank's share of
them is at most `SERVE_TP_ONLY_BUDGET`, fsdp above it
(`RunSettings.fsdp_specs`: each layer's leaves gathered just before its
blocks run); the batch is this rank's rows (over the dp axes where they
divide it), the decode cache its share (`init_cache` with `tp_size`,
`parallel/sharding.py::cache_layout_specs`), and a step returns the
whole logits of the rank's rows on every rank of the tensor axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, SpoolIoConfig
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch.op_stats import uncounted
from repro_torch.models.transformer import RunSettings
from repro_torch.parallel.mesh import local_shape
from repro_torch.parallel.sharding import (MeshAxes, batch_specs,
                                          map_with_path)
from repro_torch.runtime.trainer import batch_tokens

# Serving keeps weights TP-only (no per-step all-gather) while they fit;
# above this per-card budget the JAX dry run shards them fsdp too.
SERVE_TP_ONLY_BUDGET = 8 << 30


def _metrics(rep, batches) -> Dict:
    out = {"ce": rep.extra.get("ce", rep.loss),
           "tokens": float(sum(batch_tokens(b) for b in batches))}
    for k in ("moe_lb", "moe_z"):
        if k in rep.extra:
            out[k] = rep.extra[k]
    out.update(loss=rep.loss, report=rep)
    return out


def make_host_train_step(engine) -> Callable:
    """The serial step: forward, backward and the optimizer's fused
    update (the caller's TrainLoop stages the optimizer state between
    steps with `host_offload="opt_state"`)."""

    def step_fn(params, opt_state, batches):
        params, opt_state, rep = engine.train_step(params, opt_state,
                                                   batches)
        return params, opt_state, _metrics(rep, batches)

    return step_fn


def make_overlap_train_step(engine, opt_bridge) -> Callable:
    """The overlap step: backward hands each layer's gradients to the
    bridge (`engine.settings.opt_sink` is `opt_bridge`), whose worker
    updates that layer while backward goes on; `finish_step` joins it
    and updates the rest of the tree. `opt_state` is the bridge's light
    `(step, None, None)` once it is seeded; a full state seeds it (init
    and resume both land here)."""
    if engine.settings.opt_sink is not opt_bridge:
        raise ValueError("the engine's settings.opt_sink must be the "
                         "bridge the step drives")

    def finish(grads, opt_state, params):
        return opt_bridge.finish_step(params, grads)

    def step_fn(params, opt_state, batches):
        opt_bridge.ensure_seeded(opt_state, params)
        opt_bridge.begin_step(params, int(opt_state.step))
        params, opt_state, rep = engine.train_step(params, opt_state,
                                                   batches, update=finish)
        return params, opt_state, _metrics(rep, batches)

    return step_fn


# ====================================================================
# Counting parameters
# ====================================================================

def _named_leaves(tree):
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def count_params(params, *, exclude=("embed", "pos_embed")) -> int:
    """Number of parameters, excluding lookup-only tables (for 6ND)."""
    return sum(leaf.numel() for path, leaf in _named_leaves(params)
               if not any(n in exclude for n in path))


def active_param_count(cfg: ModelConfig, params) -> int:
    """Active parameters per token: for MoE, only top_k of the expert
    stacks (plus shared experts, router and attention) touch a token."""
    n = count_params(params)
    if not cfg.moe_num_experts:
        return n
    moe = sum(leaf.numel() for path, leaf in _named_leaves(params)
              if "moe" in path and any(s in path for s in
                                       ("w_in", "w_gate", "w_out")))
    return n - moe + (moe * cfg.moe_top_k) // cfg.moe_num_experts


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(params)[0])


# ====================================================================
# Settings and arguments
# ====================================================================

def _one_device(mesh) -> bool:
    return mesh is None or mesh.size == 1


def build_settings(cfg: ModelConfig, mesh, axes: Optional[MeshAxes], *,
                   kind: str, activation_policy: Optional[str] = None,
                   attn_chunk: int = 1024, ce_chunk: int = 512,
                   attn_impl: str = "cuda",
                   device: str = "cuda") -> RunSettings:
    """The JAX builder's settings: "offload" of "blk_in" for training
    ("keep" for serving), the chunked CE in training, the MoE's expert
    axis "model" on a mesh. `attn_impl` "cuda" runs the flash kernel
    (its meta path on the meta device); "torch" the plain attention."""
    policy = activation_policy or ("offload" if kind == "train" else "keep")
    on_mesh = not _one_device(mesh)
    axes = axes or MeshAxes()
    return RunSettings(
        attn_impl=attn_impl, attn_chunk=attn_chunk,
        activation_policy=policy, offload_names=("blk_in",),
        mesh=mesh if on_mesh else None,
        ep_axis="model" if on_mesh and cfg.moe_num_experts else None,
        tp_axis=axes.tp if on_mesh else None,
        dp_axes=axes.dp if on_mesh else (),
        param_dtype=cfg.dtype, device=device,
        ce_chunk=ce_chunk if kind == "train" else 0)


def global_params(api, device: str = "meta", seed: int = 0):
    """The global parameters: meta tensors (the init runs under
    FakeTensorMode for its shapes, nothing is allocated), or the seed's
    random weights on a real device."""
    if device != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
        return api.init(gen)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = api.init(torch.Generator())
    leaves, tdef = tree_flatten(fake)
    return tree_unflatten(tdef, [
        torch.empty(t.shape, dtype=t.dtype, device="meta") for t in leaves])


def _rank_params(global_params, specs, mesh, device: str):
    """This rank's shards of `global_params` under `specs` (a meta
    tensor of each shard's `local_shape` on the meta device)."""
    from repro_torch.core.meshrun import _zip_map, shard_tree, wrap_specs
    if device != "meta":
        return shard_tree(global_params, specs, mesh)
    return _zip_map(lambda leaf, spec: torch.empty(
        local_shape(tuple(leaf.shape), spec.spec, mesh), dtype=leaf.dtype,
        device="meta"), global_params, wrap_specs(specs))


def rank_rows(n: int, mesh, axes: Optional[MeshAxes]) -> int:
    """Rows of a global batch of `n` a rank of `mesh` holds: n over the
    dp axes where they divide it, else all n (replicated, as JAX's
    `batch_specs` lays them out)."""
    if _one_device(mesh):
        return n
    dp = (axes or MeshAxes()).dp_size(mesh)
    return n // dp if n % dp == 0 else n


def _inputs(api, shape: ShapeConfig, device: str, seed: int, *,
            for_loss: bool = True, mesh=None,
            axes: Optional[MeshAxes] = None):
    """`api.input_specs` of the cell on `device`: empty on the meta
    device; elsewhere token ids below the vocab and unit-normal
    embeddings from `seed` (a decode cell's cache zeroed, its position
    the cache's last). With a `mesh` (serving) the batch is this rank's
    rows of the global one and the cache the rank's share (`rank_rows`,
    `init_cache` with `tp_size`)."""
    spec = api.input_specs(shape, for_loss=for_loss, device=device)
    if device != "meta":
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        vocab = api.cfg.vocab_size

        def fill(t):
            if t.is_floating_point():
                return t.normal_(generator=gen)
            return t.random_(0, vocab, generator=gen)

        spec["batch"] = {k: fill(v) for k, v in spec["batch"].items()}
    if not _one_device(mesh):
        from repro_torch.core.meshrun import shard_tree
        axes = axes or MeshAxes()
        spec["batch"] = shard_tree(spec["batch"], batch_specs(
            spec["batch"], mesh, axes), mesh)
        if "cache" in spec:
            spec["cache"] = api.init_cache(
                rank_rows(shape.global_batch, mesh, axes), shape.seq_len,
                device=device, tp_size=axes.tp_size(mesh))
    if "cache" in spec and device != "meta":
        for t in tree_flatten(spec["cache"])[0]:
            t.zero_()
        spec["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                   device=device)
    return spec


@dataclass
class StepBundle:
    fn: Callable                  # one step: fn(*args)
    args: Tuple[Any, ...]         # tensors on the caller's device
    settings: RunSettings
    param_specs: Any              # this rank's layout (None: one device)
    n_params: int                 # for 6ND (excludes lookup tables)
    n_active: int
    tokens_per_step: int
    fsdp: bool
    engine: Any = None            # the train step's engine

    def close(self) -> None:
        """Drain and close the train step's engine (and its spool)."""
        if self.engine is not None:
            self.engine.close()


# ====================================================================
# Builders
# ====================================================================

def make_train_step(api, mesh, axes: Optional[MeshAxes], optimizer,
                    shape: ShapeConfig, *,
                    activation_policy: Optional[str] = None,
                    ce_chunk: int = 512,
                    settings: Optional[RunSettings] = None,
                    attn_impl: str = "cuda", attn_chunk: int = 1024,
                    device: str = "cuda", seed: int = 0,
                    io_config: Optional[SpoolIoConfig] = None) \
        -> StepBundle:
    """One optimizer step of the jit engine over the cell's batch:
    `fn(params, opt_state, batch) -> (params, opt_state, metrics)`,
    the parameters and moments updated in place."""
    from repro_torch.core.engine import StagedEngine, layer_stage_names
    from repro_torch.core.meshrun import check_mesh_config
    from repro_torch.core.policies import policy_for_jit
    from repro_torch.parallel.sharding import layout_specs
    cfg = api.cfg
    axes = axes or MeshAxes()
    settings = settings or build_settings(
        cfg, mesh, axes, kind="train", activation_policy=activation_policy,
        ce_chunk=ce_chunk, attn_impl=attn_impl, attn_chunk=attn_chunk,
        device=device)
    glob = global_params(api, device, seed)
    n_params, n_active = count_params(glob), active_param_count(cfg, glob)
    engine = StagedEngine(
        api, settings, optimizer,
        policy=policy_for_jit(settings, layer_stage_names(api)),
        io_config=io_config or SpoolIoConfig(backend="mem"),
        engine_name="jit")
    specs = None
    if settings.mesh is not None:
        check_mesh_config(cfg, mesh, axes)
        specs = layout_specs(cfg, glob, mesh, axes, fsdp=True)
        engine.mesh_run.set_specs(specs)
        params = _rank_params(glob, specs, mesh, device)
    else:
        params = glob
    del glob
    opt_state = optimizer.init(params)
    batch = _inputs(api, shape, device, seed)["batch"]

    def train_step(params, opt_state, batch):
        params, opt_state, rep = engine.train_step(params, opt_state,
                                                   [batch])
        with uncounted():               # the report's, not the step's
            metrics = _metrics(rep, [batch])
        return params, opt_state, metrics

    return StepBundle(
        fn=train_step, args=(params, opt_state, batch),
        settings=settings, param_specs=specs, n_params=n_params,
        n_active=n_active,
        tokens_per_step=shape.global_batch * shape.seq_len, fsdp=True,
        engine=engine)


def _serve_fsdp(mesh, axes: Optional[MeshAxes], params) -> bool:
    """Whether the JAX dry run shards serving weights fsdp too: above
    `SERVE_TP_ONLY_BUDGET` a card under TP alone."""
    tp = axes.tp_size(mesh) if (mesh is not None and axes is not None) \
        else 1
    return param_bytes(params) // tp > SERVE_TP_ONLY_BUDGET


@dataclass
class _Served:
    params: Any                   # this rank's (one device: the global)
    specs: Any                    # the layout (None: one device)
    settings: RunSettings
    fsdp: bool
    n_params: int
    n_active: int


def _serve_params(api, mesh, axes, settings: RunSettings, device: str,
                  seed: int) -> _Served:
    """The serving weights of a rank: the global parameters cut by the
    layout of `mesh` (`layout_specs`, TP-only or, above the budget,
    fsdp, which then sets `settings.fsdp_specs`), after
    `check_mesh_config` has refused what the blocks cannot split."""
    from repro_torch.core.meshrun import check_mesh_config, wrap_specs
    from repro_torch.parallel.sharding import layout_specs
    cfg = api.cfg
    glob = global_params(api, device, seed)
    n_params, n_active = count_params(glob), active_param_count(cfg, glob)
    fsdp = _serve_fsdp(mesh, axes, glob)
    if _one_device(mesh):
        return _Served(glob, None, settings, fsdp, n_params, n_active)
    axes = axes or MeshAxes()
    check_mesh_config(cfg, mesh, axes)
    specs = layout_specs(cfg, glob, mesh, axes, fsdp=fsdp)
    params = _rank_params(glob, specs, mesh, device)
    del glob
    if fsdp:
        settings = dataclasses.replace(settings,
                                       fsdp_specs=wrap_specs(specs))
    return _Served(params, specs, settings, fsdp, n_params, n_active)


def make_prefill_step(api, mesh, axes: Optional[MeshAxes],
                      shape: ShapeConfig, *,
                      settings: Optional[RunSettings] = None,
                      attn_impl: str = "cuda", device: str = "cuda",
                      seed: int = 0) -> StepBundle:
    """A forward over the cell's prompts without gradients:
    `fn(params, batch)` -> (last logits, decode caches), or the logits
    of a model with no decode step. On a mesh `params` and `batch` are
    this rank's (the module doc); `fn` takes any prompt length up to
    the cache's `shape.seq_len`."""
    cfg = api.cfg
    settings = settings or build_settings(cfg, mesh, axes, kind="prefill",
                                          attn_impl=attn_impl,
                                          device=device)
    emit_cache = cfg.has_decode
    sv = _serve_params(api, mesh, axes, settings, device, seed)
    settings = sv.settings

    @torch.no_grad()
    def prefill_step(params, batch):
        if emit_cache:
            return api.prefill(params, batch, settings,
                               cache_len=shape.seq_len)
        return api.forward(params, batch, settings)

    batch = _inputs(api, shape, device, seed, for_loss=False, mesh=mesh,
                    axes=axes)["batch"]
    return StepBundle(
        fn=prefill_step, args=(sv.params, batch),
        settings=settings, param_specs=sv.specs, n_params=sv.n_params,
        n_active=sv.n_active,
        tokens_per_step=shape.global_batch * shape.seq_len, fsdp=sv.fsdp)


def make_decode_step(api, mesh, axes: Optional[MeshAxes],
                     shape: ShapeConfig, *,
                     settings: Optional[RunSettings] = None,
                     attn_impl: str = "cuda", device: str = "cuda",
                     seed: int = 0) -> StepBundle:
    """One token for every row against a cache of `shape.seq_len`
    positions: `fn(params, cache, batch, pos)` -> logits (the cache
    updated in place). On a mesh `params`, `cache` and `batch` are this
    rank's (the module doc)."""
    cfg = api.cfg
    settings = settings or build_settings(cfg, mesh, axes, kind="decode",
                                          attn_impl=attn_impl,
                                          device=device)
    sv = _serve_params(api, mesh, axes, settings, device, seed)
    settings = sv.settings

    @torch.no_grad()
    def decode_step(params, cache, batch, pos):
        # the scalar position as every row's (a view): the cache write
        # takes one op on every device, where a scalar would be read
        # back to the host, which a meta tensor cannot be
        rows = next(iter(batch.values())).shape[0]
        return api.decode_step(params, cache, batch,
                               pos.reshape(1).expand(rows), settings)

    spec = _inputs(api, shape, device, seed, mesh=mesh, axes=axes)
    return StepBundle(
        fn=decode_step, args=(sv.params, spec["cache"], spec["batch"],
                              spec["pos"]),
        settings=settings, param_specs=sv.specs, n_params=sv.n_params,
        n_active=sv.n_active, tokens_per_step=shape.global_batch,
        fsdp=sv.fsdp)


def make_step(api, mesh, axes: Optional[MeshAxes], shape: ShapeConfig,
              optimizer=None, **kw) -> StepBundle:
    if shape.kind == "train":
        assert optimizer is not None
        return make_train_step(api, mesh, axes, optimizer, shape, **kw)
    kw.pop("activation_policy", None)
    kw.pop("ce_chunk", None)
    kw.pop("attn_chunk", None)
    kw.pop("io_config", None)
    if shape.kind == "prefill":
        return make_prefill_step(api, mesh, axes, shape, **kw)
    return make_decode_step(api, mesh, axes, shape, **kw)


__all__ = ["SERVE_TP_ONLY_BUDGET", "StepBundle", "active_param_count",
           "build_settings", "count_params", "global_params", "make_decode_step",
           "make_host_train_step", "make_overlap_train_step",
           "make_prefill_step", "make_step", "make_train_step",
           "param_bytes", "rank_rows"]
