"""Staged training engine: the SSDTrain data flow of paper §3.1-3.3 over
PyTorch's own saved-tensor hooks, with the semantics of the JAX
package's `repro/core/staged.py`.

A training step is a chain of stages (`embed`, `seg{si}_l{rep}` for each
layer, `head`). An encoder-decoder (T5) runs its encoder stream first
(`enc_embed`, `enc{si}_l{rep}`, `enc_final`); `enc_final`'s output, the
encoder states `enc`, is one detached leaf that every decoder stage
holding a cross block (`takes_enc`) takes as a second input, and its
cotangents from those stages add up into the carry of `enc_final`'s
backward. Each stage's forward runs on inputs detached with
`requires_grad`, under `torch.autograd.graph.saved_tensors_hooks`:

  pack hook      -> the saved tensor joins the stage's list, minus
                    parameters (any view of a parameter's storage), the
                    stage inputs (the stage input and `enc`: the engine
                    holds each as a graph leaf, `enc` through the whole
                    decoder, so storing them would free nothing) and
                    duplicates (same storage, offset, shape and stride),
                    and autograd keeps only a handle;
  after forward  -> the list goes to the spool (`tx.offload`) or stays
                    on device (`tx.keep`), as the `OffloadPolicy` says;
  backward       -> walks the stages in reverse, prefetching one stage
                    ahead (stage 0 included), fetches the stage's list
                    (forwarded or reloaded), and runs the stage's
                    autograd backward; the unpack hook serves the saved
                    tensors from the fetched list;
  Recompute      -> the stage runs forward without saving and again
                    inside backward;
  fetch failure  -> the stage is recomputed from its input (the port
                    keeps each stage's input on device as the previous
                    stage's graph root, so no host copy is needed), once
                    the spool's retries gave up (the SpoolIoConfig's
                    `on_fetch_fail`);
  health events  -> an AdaptivePolicy re-plans on the spool's backend
                    health (`attach_health`); a cache-manager backend is
                    handed to it after profiling;
  adaptive (§3.3.3) -> step 0 profiles every stage (bytes, synchronised
                    forward time), drains the spool and calibrates the
                    store path before `policy.on_profile`.

Each stage works on its own detached per-layer parameter leaves (views
of the stacked (L, ...) leaves), so a stage's backward never
materialises a full-size gradient of a stacked leaf; per-stage gradients
are written into one stacked gradient tree (`_add_grads`). The
optimizer then updates the parameters in place. When
`settings.ce_chunk` applies, the head stage is the chunked CE
(`models/api.py::chunked_ce`): it saves no (B, S, V) logits, under
either engine name (the JAX staged engine ignores the setting).

The gradient tap (the optimizer overlap, `repro_torch.optim.overlap`):
with `settings.opt_sink` set, once a layer stage's last microbatch has
added its gradients (scaled by 1/len(batches), as the update scales
them), backward hands that layer's gradient leaves (views of the stacked
tree) to `opt_sink.on_grads(step, stage, leaves)`, `step` being the
optimizer's step and `stage` the JAX package's layer numbering (decoder
layers from 0, encoder layers from `ENC_STAGE_BASE`). The step's update
(`train_step(update=...)`, the bridge's `finish_step`) then covers the
rest of the tree. The jit engine of the port is this engine under
another name (`engine_name`), its placement from
`RunSettings.activation_policy` (`core/policies.py::policy_for_jit`).

MoE aux losses follow the JAX engine of the same name. The JAX staged
engine's layer stages drop them, so under `engine_name="staged"` the
loss is the CE alone. The JAX jit engine's step is `api.loss`, which
adds `MOE_LB_COEF * moe_lb + MOE_Z_COEF * moe_z`; under "jit" a layer
stage with an MoE block returns that sum of its blocks beside its
output, backward seeds it with 1 beside the carry, the step's loss adds
every stage's term, and the report's `extra` carries `ce`, `moe_lb`
and `moe_z` (summed over layers, averaged over microbatches). On a
mesh every rank's aux term is that of the global batch (the router's
statistics are summed over the dp axes, `models/moe.py::_route`), whose
backward leaves each rank the gradient of its own rows: its seed is the
dp size, so the dp mean of the gradients is the term's gradient, and the
report counts it once (`ce` is the dp mean of the ranks' CE).

An embeddings-input model (hubert) takes `batch["embeddings"]` (float,
moved to the device as it is) through the embed stage's
`frontend_proj`.

A vision model (llama-3.2-vision) starts with a `vlm_enc` stage (the JAX
package's `repro/core/staged.py:204-210`): no parameters, it casts
`batch["enc_embeddings"]` to `settings.param_dtype`, and its output is
the `enc` every layer stage with a cross block reads. The chain ends
there, so `enc` is detached without `requires_grad`: no cotangent of it
is computed or summed, and the stage's backward is empty.

On a mesh (`settings.mesh`, one process per rank; `core/meshrun.py`)
the engine trains on this rank's rows of the batch and shards of the
parameters: a stage's leaves are gathered over the dp axes before it
runs and their gradients reduce-scattered (or all-reduced) after its
backward; the embed stages (T5's encoder's too) and the head are
vocab-parallel and the blocks tensor-parallel over `settings.tp_axis`
(`parallel/comm.py`); an
offloaded stage goes to the spool through the mesh hooks under the lease
``jit{step}/s{shard}`` (`core/hooks.py`), its tensors replicated over the
tensor axis stored as this rank's slice. A fetch that fails raises: a
recompute on one rank would run collectives the others do not.

The host tier (`core/policies.py::HostTierPolicy`, the jit name's
`activation_policy` "offload" / "offload_ssd"): layer stages are
recomputed, and after each one's forward its input (the previous
stage's output, a graph leaf; "blk_in") and the tensors its forward
marked of the policy's names ("attn_out", "mlp_hidden", "moe_hidden";
`models/marks.py`) are copied on a side stream into buffers of the
spool's CUDA-registered pool (`io/bufpool.py`), and their device
storages are freed once the copies have landed (`record_stream`, then
the storage shrunk to 0 bytes). Backward copies them back one stage
ahead, on the `reuse_horizon` walk, before the stage's recompute. No
spool record, backend or file is involved; the `MemoryTracker` counts
an input off the device while it lies on the host. Under
`SaveNamesPolicy` ("save_names") the marked tensors stay on the device,
tracked. Either way the recompute runs under `marks.replaying`: each
mark answers with its held tensor (with "attn_out" held no attention
forward runs), and every value is the one keep computes.

Counting (`launch/op_stats.py`): the host tier and the spool's offloads
report the bytes they move off the device to the active op counter, and
the host tier's copies run uncounted. On the meta device (a dry run,
`launch/steps.py`) nothing can be copied: the host tier and the spool
record the bytes and keep the tensor (the counter still sees the host
tier's tensors leave the device and come back), and the loss is not
read. No other device takes this path.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.cache.horizon import reuse_horizon
from repro_torch.configs.base import SpoolIoConfig
from repro_torch.core.accounting import MemoryTracker
from repro_torch.core.adaptive import ModuleProfile, OffloadPlan
from repro_torch.core.ids import storage_ptr, tensor_key
from repro_torch.core.policies import (KeepPolicy, OffloadPolicy,
                                       RecomputePolicy, resolve_policy)
from repro_torch.core.report import StepReport
from repro_torch.core.spool import (MIN_OFFLOAD_ELEMENTS, SpoolLoadError,
                                    build_spool)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch import op_stats
from repro_torch.models.api import (MOE_LB_COEF, MOE_Z_COEF, ModelApi,
                                    ce_chunk_applies, ce_loss, chunked_ce,
                                    embed_in, encoder_config, head)
from repro_torch.models import marks
from repro_torch.models.layers import dtype_of, rms_norm
from repro_torch.models.transformer import RunSettings, apply_block, layer
from repro_torch.parallel.comm import (saved_replicated, tp_group,
                                       vocab_parallel_ce)


#: where a layer stage's parameters (and gradients) live, by role
_SEGMENTS = {"layer": "segments", "enc_layer": "enc_segments"}

#: the first encoder layer's stage number in the gradient tap (the JAX
#: package's `repro/core/hooks.py::ENC_STAGE_BASE`): decoder layers are
#: numbered from 0, encoder layers from here
ENC_STAGE_BASE = 1 << 20


def layer_stage_names(api: ModelApi) -> List[str]:
    """The decoder layer stages' names in forward order."""
    return [f"seg{si}_l{rep}" for si, seg in enumerate(api.segments)
            for rep in range(seg.n_repeat)]


def _graph_leaf(t: torch.Tensor) -> torch.Tensor:
    """A graph leaf over `t`'s memory with a version counter of its own.
    A detached view shares its base's counter, and the optimizer overlap
    writes a finished layer's slice of a stacked parameter in place while
    backward still holds other slices of it (a recomputed stage's saved
    weights among them): autograd would take that for a modified saved
    tensor."""
    with torch.no_grad():
        leaf = torch.empty(0, dtype=t.dtype, device=t.device).set_(
            t.untyped_storage(), t.storage_offset(), t.size(), t.stride())
    return leaf.requires_grad_(True)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _HostTier:
    """The host tier's tensors, by stage index (a stage's input and the
    tensors marked inside it): each one's device storage copied into a
    lease of the spool's pool and freed (`offload`), copied back into a
    storage of its size one stage ahead (`prefetch`), and waited for
    before its stage's recompute (`restore`). Bytes move through uint8
    aliases of the storage, whose version counters are their own: the
    stage input, a graph leaf, keeps its."""

    def __init__(self, pool, tracker: MemoryTracker, device):
        self.pool, self.tracker, self.device = pool, tracker, device
        self.cuda = device.type == "cuda"
        self.dry = device.type == "meta"
        self._stream = None
        self._held: Dict[int, List[Dict[str, Any]]] = {}
        self._done: list = []       # (copy-back event, lease) of restored

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        stream = self._stream
        # the side stream starts after what the card's stream has queued:
        # the input's producer, or the last use of the memory a restored
        # storage reuses
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return stream

    @staticmethod
    def _bytes(t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
            st, 0, (st.nbytes(),), (1,))

    @staticmethod
    def movable(t: Optional[torch.Tensor]) -> bool:
        """A tensor that is its whole storage: freeing the storage frees
        nothing else."""
        return (t is not None and t.storage_offset() == 0
                and t.is_contiguous() and t.numel() * t.element_size()
                == t.untyped_storage().nbytes())

    def _copy(self, dst, src):
        """dst <- src, on the side stream on the card. Returns the copy's
        event (None on the CPU)."""
        if not self.cuda:
            dst.copy_(src)
            return None
        with torch.cuda.stream(self._side()):
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return event

    def offload(self, si: int, t: torch.Tensor, key) -> None:
        n = t.untyped_storage().nbytes()
        op_stats.count_host(n)
        op_stats.moved_off(t)
        if self.dry:
            lease = host = event = None
        else:
            with op_stats.uncounted():
                src = self._bytes(t)
                lease = self.pool.acquire(n)
                host = torch.frombuffer(lease.mv[:n], dtype=torch.uint8)
                event = self._copy(host, src)
                if event is not None:
                    src.record_stream(self._stream)  # freed after the copy
                del src
            t.untyped_storage().resize_(0)
        # a tensor the tracker never counted (one marked inside a stage)
        # frees nothing here
        self.tracker.free(key, tag=f"host:{key[0]}")
        self._held.setdefault(si, []).append(
            {"t": t, "lease": lease, "host": host, "key": key, "n": n,
             "event": event, "back": False})

    def prefetch(self, si: int) -> None:
        for rec in self._held.get(si, ()):
            if rec["back"]:
                continue
            if not self.dry:
                rec["t"].untyped_storage().resize_(rec["n"])
                # the side stream is in order: the copy out has landed
                with op_stats.uncounted():
                    rec["event"] = self._copy(self._bytes(rec["t"]),
                                              rec["host"])
            op_stats.moved_back(rec["t"])
            rec["back"] = True
            self.tracker.alloc(rec["key"], rec["n"],
                               tag=f"host_back:{rec['key'][0]}")

    def restore(self, si: int) -> None:
        """Stage si's tensors back on the device: the card's stream
        waits for their copies. The records let go of the tensors, which
        the stage's backward frees; their leases wait for `clear`."""
        if si not in self._held:
            return
        self.prefetch(si)
        for rec in self._held.pop(si):
            if rec["event"] is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    rec["event"])
            self._done.append((rec["event"], rec["lease"]))

    def clear(self) -> None:
        """Release every lease once its copies have run: the end of a
        microbatch's backward, or one that raised (a tensor still on the
        host is lost with its step)."""
        for event, lease in self._done + [
                (r["event"], r["lease"]) for recs in self._held.values()
                for r in recs]:
            if event is not None:
                event.synchronize()
            if lease is not None:
                lease.release()
        self._done, self._held = [], {}


class _Stage:
    """One module of the chain. role: vlm_enc | enc_embed | enc_layer |
    enc_final | embed | layer | head. takes_enc: fn is f(p, x, enc). aux:
    fn returns (x, {"moe_lb", "moe_z"}) (a layer with MoE blocks under
    the jit name)."""

    __slots__ = ("name", "role", "fn", "seg", "rep", "takes_enc",
                 "tap_stage", "aux")

    def __init__(self, name, role, fn, seg=-1, rep=-1, takes_enc=False,
                 tap_stage=None, aux=False):
        self.name, self.role, self.fn = name, role, fn
        self.seg, self.rep, self.takes_enc = seg, rep, takes_enc
        self.tap_stage = tap_stage      # layer number in the grad tap
        self.aux = aux


def _aux_term(aux) -> torch.Tensor:
    """A stage's share of the JAX jit loss's MoE terms."""
    return MOE_LB_COEF * aux["moe_lb"] + MOE_Z_COEF * aux["moe_z"]


def _stage_grad(out, term, inputs, carry, aux_seed: float = 1.0):
    """Gradients of a stage's output (seeded with `carry`) and of its
    MoE aux term (seeded with `aux_seed`), with respect to `inputs`
    (none for `vlm_enc`, where the chain ends)."""
    if not inputs:
        return ()
    if term is None:
        return torch.autograd.grad(out, inputs, carry, allow_unused=True)
    return torch.autograd.grad((out, term), inputs,
                               (carry, torch.full_like(term, aux_seed)),
                               allow_unused=True)


class StagedEngine:
    def __init__(self, api: ModelApi, settings: RunSettings, optimizer, *,
                 policy=None, io_config: Optional[SpoolIoConfig] = None,
                 min_offload_elements: Optional[int] = None,
                 engine_name: str = "staged"):
        io_config = io_config or SpoolIoConfig()
        #: the name in the `engine.step` span and the StepReport
        self.engine_name = engine_name
        self.api = api
        self.cfg = api.cfg
        self.settings = settings
        self.device = torch.device(settings.device)
        #: a dry run (`launch/steps.py` on the meta device): offloads are
        #: counted and kept, the loss is never read
        self._dry = self.device.type == "meta"
        self.optimizer = optimizer
        self.policy: OffloadPolicy = resolve_policy(policy)
        self.on_fetch_fail = io_config.on_fetch_fail
        self.tracker = MemoryTracker()
        self.spool = build_spool(
            io_config,
            min_offload_elements=(MIN_OFFLOAD_ELEMENTS
                                  if min_offload_elements is None
                                  else min_offload_elements),
            tracker=self.tracker, cuda=self.device.type == "cuda")
        # mid-run re-plan: the policy watches the spool's health monitor
        if hasattr(self.policy, "attach_health"):
            self.policy.attach_health(self.spool.health)
        # a mesh (`core/meshrun.py`): this rank's batch rows, parameter
        # shards, gradient reductions and its mesh hooks (`core/hooks.py`)
        self._mesh = None
        if settings.mesh is not None:
            from repro_torch.core.meshrun import MeshRun, mesh_bridge
            self._mesh = MeshRun(settings)
            self._mesh.bridge = mesh_bridge(
                self._mesh, self.spool, io_config,
                offloads=not isinstance(self.policy,
                                        (KeepPolicy, RecomputePolicy)))
        # the MoE aux terms' seed: the dp mean of the gradients divides
        # each rank's gradient of the global term by the dp size
        self._aux_seed = (float(self._mesh.dp_size) if self._mesh is not None
                          else 1.0)
        self._stages = self._build_stages()
        # the names a recomputed stage holds from its forward to its
        # recompute (`models/marks.py`), and the host tier, where they or
        # the stages' inputs wait in pinned host memory
        self._inner = tuple(self.policy.inner_names)
        self._host = (_HostTier(self.spool.pool, self.tracker, self.device)
                      if self.policy.host_inputs or (
                          self._inner and self.policy.inner_on_host)
                      else None)
        self._step = 0
        self._closed = False
        self._flags: list = []          # the current stage's (`_hooks`)

    @property
    def mesh_run(self):
        """The engine's `core/meshrun.py::MeshRun` (None off a mesh)."""
        return self._mesh

    @property
    def plan(self) -> Optional[OffloadPlan]:
        return self.policy.plan

    @property
    def stage_names(self) -> List[str]:
        return [s.name for s in self._stages]

    # ------------------------------------------------------ stage chain

    def _build_stages(self) -> List[_Stage]:
        cfg, settings = self.cfg, self.settings

        def with_aux(seg) -> bool:
            # the JAX jit engine's loss adds the MoE terms; its staged
            # engine drops them
            return self.engine_name == "jit" and any(
                b.mlp == "moe" for b in seg.blocks)

        def layer_fn(seg, lcfg):
            collect = with_aux(seg)

            def fn(p_layer, x, enc=None):
                positions = (torch.arange(x.shape[1], device=x.device)
                             if lcfg.use_rope else None)
                aux = {} if collect else None
                for i, bdef in enumerate(seg.blocks):
                    x, _ = apply_block(bdef, p_layer[f"b{i}"], x, lcfg,
                                       settings, positions=positions,
                                       enc_kv=enc, aux=aux)
                return (x, aux) if collect else x
            return fn

        stages = []
        tp = tp_group(settings)
        if cfg.family == "vlm":
            # the JAX staged engine's cast: the run's dtype (the API's
            # enc_states casts with the config's)
            enc_dtype = dtype_of(settings.param_dtype)
            stages.append(_Stage("vlm_enc", "vlm_enc", lambda p, batch: (
                batch["enc_embeddings"].to(enc_dtype))))
        if self.api.enc_segments:
            enc_cfg = encoder_config(cfg)
            stages.append(_Stage(
                "enc_embed", "enc_embed", lambda p, batch: embed_in(
                    p, {"tokens": batch["enc_tokens"]}, enc_cfg, tp)))
            n = ENC_STAGE_BASE
            for si, seg in enumerate(self.api.enc_segments):
                fn = layer_fn(seg, enc_cfg)
                for rep in range(seg.n_repeat):
                    stages.append(_Stage(f"enc{si}_l{rep}", "enc_layer", fn,
                                         si, rep, tap_stage=n))
                    n += 1
            stages.append(_Stage("enc_final", "enc_final", lambda p, x: (
                rms_norm(x, p["enc_norm"]["scale"], cfg.norm_eps))))
        stages.append(_Stage("embed", "embed",
                             lambda p, batch: embed_in(p, batch, cfg, tp)))
        names = iter(layer_stage_names(self.api))
        n = 0
        for si, seg in enumerate(self.api.segments):
            fn = layer_fn(seg, cfg)
            takes_enc = any(b.mixer == "cross" for b in seg.blocks)
            for rep in range(seg.n_repeat):
                stages.append(_Stage(next(names), "layer", fn, si, rep,
                                     takes_enc, tap_stage=n,
                                     aux=with_aux(seg)))
                n += 1

        def head_fn(p, x, labels):
            # chunked CE saves the stage input (held as a graph leaf
            # anyway), the parameters and the labels: no (B, S, V) logits
            if ce_chunk_applies(settings.ce_chunk, labels.shape[1]):
                return chunked_ce(p, x, labels, cfg, settings.ce_chunk,
                                  tp)[0]
            if tp is not None:
                return vocab_parallel_ce(head(p, x, cfg, tp), labels, tp)[0]
            return ce_loss(head(p, x, cfg), labels)[0]
        stages.append(_Stage("head", "head", head_fn))
        return stages

    def _stage_params(self, params) -> List[Any]:
        """Per-stage parameter trees of detached leaves that require grad
        (layer stages: views of the stacked leaves' rep-th slices; the
        encoder's and the decoder's embed stages each their own leaves of
        the shared tables). Only an opt sink writes a stage's slices while
        backward holds others, so only then does each leaf get a version
        counter of its own (`_graph_leaf`): elsewhere autograd's check
        of saved tensors stays whole. On a mesh each leaf is this rank's
        shard with its dp-sharded dim gathered (`MeshRun.gather_stage`),
        and `self._stage_specs` holds each stage's leaf specs."""
        leaf_of = (_graph_leaf if self.settings.opt_sink is not None
                   else lambda t: t.detach().requires_grad_(True))
        out = []
        if self._mesh is None:
            for tree in self._stage_trees(params):
                leaves, tdef = tree_flatten(tree)
                out.append(tree_unflatten(tdef, [leaf_of(t)
                                                 for t in leaves]))
            return out
        self._stage_specs = []
        for tree, specs in zip(self._stage_trees(params),
                               self._stage_trees(self._mesh.specs)):
            leaves, tdef = tree_flatten(tree)
            specs = tree_flatten(specs)[0]
            self._stage_specs.append(specs)
            out.append(tree_unflatten(tdef, [
                leaf_of(t) for t in self._mesh.gather_stage(leaves, specs)]))
        return out

    def _stage_trees(self, params) -> List[Any]:
        """Each stage's subtree of `params` (or of a tree shaped like it)."""
        emb = {k: params[k] for k in ("embed", "pos_embed", "frontend_proj")
               if k in params}
        out = []
        for st in self._stages:
            if st.role in ("enc_embed", "embed"):
                tree = emb
            elif st.role == "vlm_enc":
                tree = {}
            elif st.role == "enc_final":
                tree = {"enc_norm": params["enc_norm"]}
            elif st.role == "head":
                tree = {"final_norm": params["final_norm"],
                        "unembed": params["unembed"]}
            else:
                tree = layer(params[_SEGMENTS[st.role]][st.seg], st.rep)
            out.append(tree)
        return out

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """Token ids and labels as int64 on the device; float inputs
        (`embeddings`, `enc_embeddings`) in their own dtype."""
        if self._mesh is not None:
            batch = self._mesh.local_batch(batch)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            out[k] = t.to(self.device, None if t.is_floating_point()
                          else torch.long)
        return out

    # ------------------------------------------------------------ step

    def train_step(self, params, opt_state, batches: Sequence[Dict], *,
                   update=None) -> Tuple[Any, Any, StepReport]:
        """One optimizer step over `batches` micro-batches (numpy or
        tensor {"tokens", "labels"}); updates params in place through
        `update(grads, opt_state, params) -> (params, opt_state)` (the
        optimizer's fused update by default). With an opt sink the layer
        gradients were handed over (and scaled) in backward, so `update`
        is the sink's own."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        self.tracker.reset_peak()
        self.spool.register_parameters(params)
        stage_params = self._stage_params(params)
        self._n_mb = len(batches)
        mesh = self._mesh
        if mesh is not None:
            # the gathered leaves are parameters too: never spooled
            self.spool.register_parameters([params, stage_params])
            staged0 = mesh.comm.host_staged_bytes
            comm0 = dict(mesh.comm.seconds)
        profiles = [ModuleProfile(s.name, 0, 0.0) for s in self._stages]
        profiling = self.policy.wants_profile and self._step == 0
        grads: Dict[str, Any] = {}
        counts = {"stages_offloaded": 0, "stages_kept": 0,
                  "stages_recomputed": 0, "stages_fetched": 0,
                  "layer_saved_bytes": 0, "forward_s": 0.0,
                  "backward_s": 0.0}
        if any(s.aux for s in self._stages):
            counts.update(ce=0.0, moe_lb=0.0, moe_z=0.0)
        if self._host is not None:
            # layer stages whose input went to the host tier
            counts["stages_host"] = 0
        if self._inner:
            # the bytes of the tensors marked inside the layer stages
            # that were held (on the host or on the device)
            counts["named_bytes"] = 0
        loss_total, bwd_begin, dev_bwd_begin = 0.0, 0, 0
        sink = self.settings.opt_sink
        # the tap's step: the optimizer's, as the JAX hooks key it
        tap = (sink, int(opt_state.step), len(batches)) if sink else None
        with obs.span("engine.step", cat="engine", step=self._step,
                      engine=self.engine_name):
            for mb, batch in enumerate(batches):
                with self.spool.step(f"mb{mb}") as tx:
                    loss, bb, dbb = self._run_microbatch(
                        tx, mb, self._to_device(batch), stage_params,
                        params, grads, profiles, profiling, counts,
                        tap if mb == len(batches) - 1 else None)
                loss_total += loss
                bwd_begin, dev_bwd_begin = max(bwd_begin, bb), max(
                    dev_bwd_begin, dbb)
            del stage_params
            t_opt = time.perf_counter()
            with obs.span("engine.update", cat="engine", step=self._step):
                if len(batches) > 1:
                    scale = 1.0 / len(batches)
                    # tapped layer gradients were scaled before the tap
                    rest = ({k: v for k, v in grads.items()
                             if k not in _SEGMENTS.values()}
                            if sink else grads)
                    for g in tree_flatten(rest)[0]:
                        g.mul_(scale)
                if mesh is not None and update is None:
                    params, opt_state = self.optimizer.update(
                        grads, opt_state, params, sq_norm=mesh.sq_norm)
                else:
                    params, opt_state = (update or self.optimizer.update)(
                        grads, opt_state, params)
                del grads
                if cuda:
                    torch.cuda.synchronize(self.device)
            counts["optimizer_s"] = time.perf_counter() - t_opt
        # the store tail is not synchronised: writes overlap the next
        # step's forward; only the profiling step drains (to measure)
        if profiling:
            self.spool.wait_io()
        step_time = time.perf_counter() - t0
        if profiling:
            max_bytes = max((p.bytes for p in profiles), default=0)
            self.spool.calibrate_backend(min(max_bytes, 8 << 20))
            cm = self.spool.cache_manager
            if cm is not None and hasattr(self.policy,
                                          "attach_cache_manager"):
                self.policy.attach_cache_manager(cm)
            self.policy.on_profile(profiles, self.spool.planner_bandwidth())
        self._step += 1
        extra = dict(counts)
        if mesh is not None:
            loss_total = mesh.mean_loss(loss_total)
            if "ce" in extra:
                extra["ce"] = mesh.mean_loss(extra["ce"])
            extra["comm_host_staged_bytes"] = (mesh.comm.host_staged_bytes
                                               - staged0)
            for k, v in mesh.comm.seconds.items():
                extra[f"comm_{k}_s"] = v - comm0[k]
        for k in ("ce", "moe_lb", "moe_z"):
            if k in extra:
                extra[k] /= len(batches)
        if cuda:
            extra["device_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            extra["device_backward_begin_bytes"] = dev_bwd_begin
        return params, opt_state, StepReport(
            loss=loss_total / len(batches), step_time=step_time,
            peak_activation_bytes=self.tracker.peak,
            backward_begin_bytes=bwd_begin, stats=self.spool.stats,
            plan=self.plan, step=self._step, engine=self.engine_name,
            extra=extra)

    def _run_microbatch(self, tx, mb, batch, stage_params, params, grads,
                        profiles, profiling, counts, tap=None):
        """Forward and backward of one microbatch under lease `tx`;
        accumulates into `grads`. `tap`: (sink, step, microbatches) on
        the step's last microbatch with an opt sink. Returns (loss,
        tracked and device bytes at the start of backward)."""
        sync = profiling and self.device.type == "cuda"
        t_fwd = time.perf_counter()
        fwd_sp = obs.span("engine.fwd", cat="engine", step=self._step, mb=mb)
        fwd_sp.__enter__()
        x = enc = None                         # the stream; encoder states
        ins: Dict[int, torch.Tensor] = {}      # stage input (graph leaf)
        outs: Dict[int, torch.Tensor] = {}     # stage output (graph root)
        cells: Dict[int, list] = {}            # fetched saved tensors
        named: Dict[int, list] = {}            # held (name, tensor, key)
        terms: Dict[int, torch.Tensor] = {}    # MoE aux terms (graph roots)
        auxes = []                             # every aux stage's values
        recompute = set()
        bridged = set()                        # stored through the mesh hooks
        step_key = (self._step if self._n_mb == 1
                    else f"{self._step}.{mb}")
        loss = None
        for si, stage in enumerate(self._stages):
            args = self._args_for(stage, batch, x, enc)
            tin = time.perf_counter()
            if self.policy.recomputes(stage.role):
                with torch.no_grad(), marks.recording(self._inner) as held:
                    out = stage.fn(stage_params[si], *args)
                if stage.aux:
                    out, aux = out
                    auxes.append(aux)
                recompute.add(si)
                self.tracker.alloc((tx.key(si), "k"), _nbytes([x]),
                                   tag=f"ckpt:{tx.key(si)}")
                counts["stages_recomputed"] += 1
                saved = None
                if self.policy.host_inputs and \
                        _HostTier.movable(ins.get(si)):
                    self._host.offload(si, ins[si], (tx.key(si), "k"))
                    counts["stages_host"] += 1
                if held:
                    named[si] = self._hold(tx, si, held, counts)
                del held
            else:
                saved, cell = [], []
                flags = self._flags = []
                with torch.autograd.graph.saved_tensors_hooks(
                        *self._hooks(saved, cell, ins.get(si), enc)), \
                        self._save_scope():
                    out = stage.fn(stage_params[si], *args)
                    if stage.aux:
                        out, aux = out
                        # the values only: the graph goes with terms[si]
                        auxes.append({k: v.detach() for k, v in aux.items()})
                        terms[si] = _aux_term(aux)
                cells[si] = cell
            if sync:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - tin
            if saved is not None:
                profile = ModuleProfile(stage.name, _nbytes(saved), dt)
                if self.policy.should_offload(si, profile):
                    op_stats.count_host(profile.bytes)
                    if self._dry:
                        tx.keep(si, saved)
                    elif self._mesh is not None:
                        # shard-qualified keys in the ranks' shared dir
                        with op_stats.uncounted():
                            self._mesh.offload(step_key, si, saved, flags)
                        bridged.add(si)
                    else:
                        with op_stats.uncounted():
                            tx.offload(si, saved)
                    counts["stages_offloaded"] += 1
                else:
                    tx.keep(si, saved)
                    counts["stages_kept"] += 1
                profiles[si] = profile
                if stage.role in _SEGMENTS:
                    # what the analytic count of Table 4 models
                    counts["layer_saved_bytes"] += profile.bytes
                # the graph holds the pack hook, and so this list: empty
                # it, or every spooled tensor stays on the device
                saved.clear()
            outs[si] = out
            if stage.role == "head":
                loss = out
            elif stage.role == "enc_final":
                # the decoder's embed stage takes the batch, not this
                enc = out.detach().requires_grad_(True)
            elif stage.role == "vlm_enc":
                # the chain ends here: no cotangent of enc is needed
                enc = out.detach()
            else:
                x = out.detach().requires_grad_(True)
                ins[si + 1] = x
        self.tracker.mark(f"backward_begin_{tx.step_id}")
        bwd_begin = self.tracker.current
        dev_bwd_begin = (torch.cuda.memory_allocated(self.device)
                         if self.device.type == "cuda" else 0)
        # waits for the forward (a dry run's loss holds no value)
        loss_value = 0.0 if self._dry else float(loss.detach())
        weight = 1.0
        if self._mesh is not None:
            # this rank's share of the dp mean (`MeshRun.loss_weight`)
            weight = self._mesh.loss_weight(batch["labels"])
            loss_value *= weight
        if auxes and not self._dry:
            counts["ce"] += loss_value
            for k in ("moe_lb", "moe_z"):
                counts[k] += float(torch.stack([a[k] for a in auxes]).sum())
            loss_value += float(sum(_aux_term(a) for a in auxes))
        fwd_sp.__exit__(None, None, None)
        t_bwd = time.perf_counter()
        counts["forward_s"] += t_bwd - t_fwd
        bwd_sp = obs.span("engine.bwd", cat="engine", step=self._step, mb=mb)
        bwd_sp.__enter__()

        try:
            self._backward(tx, batch, stage_params, params, grads, ins,
                           outs, cells, terms, recompute, enc, counts, tap,
                           weight, bridged, step_key, named)
            if bridged:
                # the replicas in other processes have read every stage
                # this rank stored for them
                self._mesh.settle()
        finally:
            if self._host is not None:
                self._host.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        bwd_sp.__exit__(None, None, None)
        counts["backward_s"] += time.perf_counter() - t_bwd
        return loss_value, bwd_begin, dev_bwd_begin

    def _backward(self, tx, batch, stage_params, params, grads, ins, outs,
                  cells, terms, recompute, enc, counts, tap, weight,
                  bridged, step_key, named):
        """The stages' backward in reverse order, prefetching one stage
        ahead; accumulates into `grads` (`_run_microbatch`). `weight`
        seeds the loss's gradient; `bridged` stages come back through
        the mesh hooks (key `step_key`); `named` holds the tensors each
        recomputed stage's forward held (`_hold`)."""
        carry = torch.full((), weight, dtype=torch.float32,
                           device=self.device)
        enc_grad = None          # d loss / d enc, summed over cross stages
        host = self._host
        for si in range(len(self._stages) - 1, -1, -1):
            stage = self._stages[si]
            for s in reuse_horizon(range(si - 1, -1, -1)):
                tx.prefetch(s)
                if host is not None:
                    host.prefetch(s)
            leaves = tree_flatten(stage_params[si])[0]
            enc_in = stage.takes_enc and enc.requires_grad
            inputs = leaves + ([ins[si]] if si in ins else []) + (
                [enc] if enc_in else [])
            if si in recompute:
                if host is not None:
                    host.restore(si)
                held = named.pop(si, [])
                keys = [key for _, _, key in held]
                # the recompute takes each tensor out of this list, and
                # its graph frees it once the backward has read it
                held = [(n, t) for n, t, _ in held]
                got = self._recompute(stage, stage_params[si], batch, ins,
                                      enc, si, inputs, carry, held)
                self.tracker.free((tx.key(si), "k"),
                                  tag=f"ckpt_done:{tx.key(si)}")
                for key in keys:
                    self.tracker.free(key, tag=f"named_done:{key[0]}")
            elif si in bridged:
                # on a mesh a fetch that fails raises: a recompute on one
                # rank would run collectives the others do not
                with op_stats.uncounted():
                    fetched = self._mesh.fetch(step_key, si)
                op_stats.track(fetched)
                counts["stages_fetched"] += 1
                cells[si][:] = fetched
                try:
                    got = _stage_grad(outs[si], terms.get(si), inputs,
                                      carry, self._aux_seed)
                finally:
                    cells[si].clear()
                del fetched
            else:
                try:
                    with op_stats.uncounted():
                        fetched = tx.fetch(si)
                    op_stats.track(fetched)
                    counts["stages_fetched"] += 1
                except SpoolLoadError as e:
                    # the blob is gone: recompute the stage from its
                    # input, the bottom rung of the degradation ladder
                    if self.on_fetch_fail != "recompute":
                        raise
                    self.spool.stats.fetch_fallbacks += 1
                    if obs.is_enabled():
                        obs.count("resilience.fetch_fallback")
                        obs.instant("resilience.fetch_fallback",
                                    cat="resilience", stage=stage.name,
                                    key=tx.key(si), error=repr(e))
                    fetched = None
                if fetched is None:
                    got = self._recompute(stage, stage_params[si], batch,
                                          ins, enc, si, inputs, carry)
                else:
                    cells[si][:] = fetched
                    try:
                        got = _stage_grad(outs[si], terms.get(si), inputs,
                                          carry, self._aux_seed)
                    finally:
                        # a backward that raises leaves its graph's saved
                        # tensors unpacked, and their unpack hook holds
                        # this cell: emptied, or the cell, graph and
                        # tensors keep each other alive past the step
                        cells[si].clear()
                    del fetched
                tx.drop(si)
            outs.pop(si)
            terms.pop(si, None)
            cells.pop(si, None)
            if enc_in:
                enc_grad = (got[-1] if enc_grad is None
                            else enc_grad + got[-1])
                got = got[:-1]
            if si in ins:
                carry = got[-1]
                ins.pop(si)
            elif stage.role == "embed" and enc is not None:
                # the decoder stream is done: enc_final's backward next
                carry, enc_grad, enc = enc_grad, None, None
            got = got[:len(leaves)]
            if self._mesh is not None:
                got = self._mesh.reduce_grads(
                    [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, got)], self._stage_specs[si])
            self._add_grads(grads, params, stage, stage_params[si], got)
            if tap is not None and stage.tap_stage is not None:
                self._tap(grads, stage, *tap)

    def _save_scope(self):
        """Where the pack hook can tell a tensor replicated across the
        tensor axis (`parallel/comm.py::save_scope`): on a tensor axis."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return self._mesh.scope()

    def _hooks(self, saved: list, cell: list, x_in=None, enc=None):
        """(pack, unpack) for one stage: saved tensors, minus parameters,
        views of the stage input `x_in` or of the encoder states `enc`
        and duplicates, collect in `saved` (and in `self._flags`, on a
        mesh, whether each is the same on every rank of the tensor
        axis); unpack serves them from `cell`, which backward fills with
        the fetched list."""
        is_param = self.spool.registry.is_parameter
        flags = self._flags if self._mesh is not None else None
        leaf_ptrs = {storage_ptr(t) for t in (x_in, enc) if t is not None}
        index: Dict[Tuple, int] = {}

        def pack(t):
            if is_param(t) or storage_ptr(t) in leaf_ptrs:
                return (False, t)
            k = tensor_key(t)
            pos = index.get(k)
            if pos is None:
                pos = index[k] = len(saved)
                saved.append(t)
                if flags is not None:
                    flags.append(saved_replicated(t))
            return (True, pos)

        def unpack(h):
            stored, v = h
            return cell[v] if stored else v

        return pack, unpack

    @staticmethod
    def _args_for(stage: _Stage, batch, x, enc):
        if stage.role in ("vlm_enc", "enc_embed", "embed"):
            return (batch,)
        if stage.role == "head":
            return (x, batch["labels"])
        if stage.takes_enc:
            return (x, enc)
        return (x,)

    def _hold(self, tx, si, held, counts) -> list:
        """Keep the tensors a recomputed stage's forward marked (`held`,
        (name, tensor) in order) until its recompute: on the device,
        tracked, or in pinned host memory through the host tier (a
        tensor that is not its whole storage copied first, so that
        freeing it frees its bytes). Returns (name, tensor, key) each."""
        out = []
        for j, (name, t) in enumerate(held):
            key = (tx.key(si), f"n{j}")
            n = t.numel() * t.element_size()
            if self.policy.inner_on_host:
                if not _HostTier.movable(t):
                    t = t.clone()
                self._host.offload(si, t, key)
            else:
                self.tracker.alloc(key, n, tag=f"named:{key[0]}")
            counts["named_bytes"] += n
            out.append((name, t, key))
        return out

    def _recompute(self, stage, p, batch, ins, enc, si, inputs, carry,
                   held=None):
        """The stage's forward again, under autograd, then its backward
        (RecomputePolicy stages, and the fetch-failure fallback). `held`:
        the (name, tensor) its forward held, which its marks take out of
        the list in place of computing them (`models/marks.py`)."""
        with torch.enable_grad():
            with marks.replaying(self._inner, [] if held is None else held):
                out = stage.fn(p, *self._args_for(stage, batch, ins.get(si),
                                                  enc))
            term = None
            if stage.aux:
                out, aux = out
                term = _aux_term(aux)
            return _stage_grad(out, term, inputs, carry, self._aux_seed)

    def _add_grads(self, grads, params, stage, p_stage, got) -> None:
        """Write (or add, for later microbatches, and for the shared
        tables the encoder's embed stage also reads) a stage's gradients
        into the stacked gradient tree shaped like `params`."""
        leaves, tdef = tree_flatten(p_stage)
        got = [torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, got)]
        tree = tree_unflatten(tdef, got)
        if stage.role not in _SEGMENTS:
            for k, v in tree.items():
                if k in grads:
                    for a, b in zip(tree_flatten(grads[k])[0],
                                    tree_flatten(v)[0]):
                        a.add_(b)
                else:
                    grads[k] = v
            return
        key = _SEGMENTS[stage.role]
        segs = grads.setdefault(key, [None] * len(params[key]))
        if segs[stage.seg] is None:
            p_leaves, p_def = tree_flatten(params[key][stage.seg])
            segs[stage.seg] = tree_unflatten(
                p_def, [torch.zeros_like(t) for t in p_leaves])
        for dst, g in zip(tree_flatten(segs[stage.seg])[0],
                          tree_flatten(tree)[0]):
            dst[stage.rep].add_(g)

    @staticmethod
    def _tap(grads, stage, sink, step, n_batches) -> None:
        """Hand a layer stage's finished gradients to the opt sink:
        views of its slice of the stacked gradient tree, scaled first
        by 1/n_batches as the update would scale them."""
        seg = grads[_SEGMENTS[stage.role]][stage.seg]
        leaves = [g[stage.rep] for g in tree_flatten(seg)[0]]
        if n_batches > 1:
            for g in leaves:
                g.mul_(1.0 / n_batches)
        sink.on_grads(step, stage.tap_stage, leaves)

    def close(self) -> None:
        """Idempotent: drain and join the spool (and remove the temp dir
        it created)."""
        if self._closed:
            return
        self._closed = True
        if self._mesh is not None and self._mesh.bridge is not None:
            self._mesh.bridge.close()   # a step that raised left leases
        self.spool.close()
