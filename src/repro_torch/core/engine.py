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
                    stage's graph root, so no host copy is needed);
  adaptive (§3.3.3) -> step 0 profiles every stage (bytes, synchronised
                    forward time), drains the spool and calibrates the
                    store path before `policy.on_profile`.

Each stage works on its own detached per-layer parameter leaves (views
of the stacked (L, ...) leaves), so a stage's backward never
materialises a full-size gradient of a stacked leaf; per-stage gradients
are written into one stacked gradient tree (`_add_grads`). The
optimizer then updates the parameters in place.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.cache.horizon import reuse_horizon
from repro_torch.configs.base import SpoolIoConfig
from repro_torch.core.accounting import MemoryTracker
from repro_torch.core.adaptive import ModuleProfile, OffloadPlan
from repro_torch.core.ids import storage_ptr, tensor_key
from repro_torch.core.policies import OffloadPolicy, resolve_policy
from repro_torch.core.report import StepReport
from repro_torch.core.spool import (MIN_OFFLOAD_ELEMENTS, SpoolLoadError,
                                    build_spool)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.models.api import (ModelApi, ce_loss, embed_in,
                                    encoder_config, head)
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import RunSettings, apply_block, layer


#: where a layer stage's parameters (and gradients) live, by role
_SEGMENTS = {"layer": "segments", "enc_layer": "enc_segments"}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Stage:
    """One module of the chain. role: enc_embed | enc_layer | enc_final |
    embed | layer | head. takes_enc: fn is f(p, x, enc)."""

    __slots__ = ("name", "role", "fn", "seg", "rep", "takes_enc")

    def __init__(self, name, role, fn, seg=-1, rep=-1, takes_enc=False):
        self.name, self.role, self.fn = name, role, fn
        self.seg, self.rep, self.takes_enc = seg, rep, takes_enc


class StagedEngine:
    def __init__(self, api: ModelApi, settings: RunSettings, optimizer, *,
                 policy=None, io_config: Optional[SpoolIoConfig] = None,
                 min_offload_elements: Optional[int] = None,
                 on_fetch_fail: str = "recompute"):
        if on_fetch_fail not in ("recompute", "raise"):
            raise ValueError(f"on_fetch_fail must be recompute|raise, not "
                             f"{on_fetch_fail!r}")
        self.api = api
        self.cfg = api.cfg
        self.settings = settings
        self.device = torch.device(settings.device)
        self.optimizer = optimizer
        self.policy: OffloadPolicy = resolve_policy(policy)
        self.on_fetch_fail = on_fetch_fail
        self.tracker = MemoryTracker()
        self.spool = build_spool(
            io_config or SpoolIoConfig(),
            min_offload_elements=(MIN_OFFLOAD_ELEMENTS
                                  if min_offload_elements is None
                                  else min_offload_elements),
            tracker=self.tracker)
        self._stages = self._build_stages()
        self._step = 0
        self._closed = False

    @property
    def plan(self) -> Optional[OffloadPlan]:
        return self.policy.plan

    @property
    def stage_names(self) -> List[str]:
        return [s.name for s in self._stages]

    # ------------------------------------------------------ stage chain

    def _build_stages(self) -> List[_Stage]:
        cfg, settings = self.cfg, self.settings

        def layer_fn(seg, lcfg):
            def fn(p_layer, x, enc=None):
                positions = (torch.arange(x.shape[1], device=x.device)
                             if lcfg.use_rope else None)
                for i, bdef in enumerate(seg.blocks):
                    x, _ = apply_block(bdef, p_layer[f"b{i}"], x, lcfg,
                                       settings, positions=positions,
                                       enc_kv=enc)
                return x
            return fn

        stages = []
        if self.api.enc_segments:
            enc_cfg = encoder_config(cfg)
            stages.append(_Stage(
                "enc_embed", "enc_embed", lambda p, batch: embed_in(
                    p, {"tokens": batch["enc_tokens"]}, enc_cfg)))
            for si, seg in enumerate(self.api.enc_segments):
                fn = layer_fn(seg, enc_cfg)
                for rep in range(seg.n_repeat):
                    stages.append(_Stage(f"enc{si}_l{rep}", "enc_layer", fn,
                                         si, rep))
            stages.append(_Stage("enc_final", "enc_final", lambda p, x: (
                rms_norm(x, p["enc_norm"]["scale"], cfg.norm_eps))))
        stages.append(_Stage("embed", "embed",
                             lambda p, batch: embed_in(p, batch, cfg)))
        for si, seg in enumerate(self.api.segments):
            fn = layer_fn(seg, cfg)
            takes_enc = any(b.mixer == "cross" for b in seg.blocks)
            for rep in range(seg.n_repeat):
                stages.append(_Stage(f"seg{si}_l{rep}", "layer", fn, si, rep,
                                     takes_enc))

        def head_fn(p, x, labels):
            return ce_loss(head(p, x, cfg), labels)[0]
        stages.append(_Stage("head", "head", head_fn))
        return stages

    def _stage_params(self, params) -> List[Any]:
        """Per-stage parameter trees of detached leaves that require grad
        (layer stages: views of the stacked leaves' rep-th slices; the
        encoder's and the decoder's embed stages each their own leaves of
        the shared tables)."""
        emb = {k: params[k] for k in ("embed", "pos_embed") if k in params}
        out = []
        for st in self._stages:
            if st.role in ("enc_embed", "embed"):
                tree = emb
            elif st.role == "enc_final":
                tree = {"enc_norm": params["enc_norm"]}
            elif st.role == "head":
                tree = {"final_norm": params["final_norm"],
                        "unembed": params["unembed"]}
            else:
                tree = layer(params[_SEGMENTS[st.role]][st.seg], st.rep)
            leaves, tdef = tree_flatten(tree)
            out.append(tree_unflatten(
                tdef, [t.detach().requires_grad_(True) for t in leaves]))
        return out

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, torch.long)
                for k, v in batch.items()}

    # ------------------------------------------------------------ step

    def train_step(self, params, opt_state, batches: Sequence[Dict]
                   ) -> Tuple[Any, Any, StepReport]:
        """One optimizer step over `batches` micro-batches (numpy or
        tensor {"tokens", "labels"}); updates params in place."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        self.tracker.reset_peak()
        self.spool.register_parameters(params)
        stage_params = self._stage_params(params)
        profiles = [ModuleProfile(s.name, 0, 0.0) for s in self._stages]
        profiling = self.policy.wants_profile and self._step == 0
        grads: Dict[str, Any] = {}
        counts = {"stages_offloaded": 0, "stages_kept": 0,
                  "stages_recomputed": 0, "stages_fetched": 0,
                  "layer_saved_bytes": 0, "forward_s": 0.0,
                  "backward_s": 0.0}
        loss_total, bwd_begin, dev_bwd_begin = 0.0, 0, 0
        with obs.span("engine.step", cat="engine", step=self._step,
                      engine="staged"):
            for mb, batch in enumerate(batches):
                with self.spool.step(f"mb{mb}") as tx:
                    loss, bb, dbb = self._run_microbatch(
                        tx, mb, self._to_device(batch), stage_params,
                        params, grads, profiles, profiling, counts)
                loss_total += loss
                bwd_begin, dev_bwd_begin = max(bwd_begin, bb), max(
                    dev_bwd_begin, dbb)
            del stage_params
            t_opt = time.perf_counter()
            with obs.span("engine.update", cat="engine", step=self._step):
                if len(batches) > 1:
                    scale = 1.0 / len(batches)
                    for g in tree_flatten(grads)[0]:
                        g.mul_(scale)
                params, opt_state = self.optimizer.update(grads, opt_state,
                                                          params)
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
            self.policy.on_profile(profiles, self.spool.planner_bandwidth())
        self._step += 1
        extra = dict(counts)
        if cuda:
            extra["device_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            extra["device_backward_begin_bytes"] = dev_bwd_begin
        return params, opt_state, StepReport(
            loss=loss_total / len(batches), step_time=step_time,
            peak_activation_bytes=self.tracker.peak,
            backward_begin_bytes=bwd_begin, stats=self.spool.stats,
            plan=self.plan, step=self._step, engine="staged", extra=extra)

    def _run_microbatch(self, tx, mb, batch, stage_params, params, grads,
                        profiles, profiling, counts):
        """Forward and backward of one microbatch under lease `tx`;
        accumulates into `grads`. Returns (loss, tracked and device bytes
        at the start of backward)."""
        sync = profiling and self.device.type == "cuda"
        t_fwd = time.perf_counter()
        fwd_sp = obs.span("engine.fwd", cat="engine", step=self._step, mb=mb)
        fwd_sp.__enter__()
        x = enc = None                         # the stream; encoder states
        ins: Dict[int, torch.Tensor] = {}      # stage input (graph leaf)
        outs: Dict[int, torch.Tensor] = {}     # stage output (graph root)
        cells: Dict[int, list] = {}            # fetched saved tensors
        recompute = set()
        loss = None
        for si, stage in enumerate(self._stages):
            args = self._args_for(stage, batch, x, enc)
            tin = time.perf_counter()
            if self.policy.recomputes(stage.role):
                with torch.no_grad():
                    out = stage.fn(stage_params[si], *args)
                recompute.add(si)
                self.tracker.alloc((tx.key(si), "k"), _nbytes([x]),
                                   tag=f"ckpt:{tx.key(si)}")
                counts["stages_recomputed"] += 1
                saved = None
            else:
                saved, cell = [], []
                with torch.autograd.graph.saved_tensors_hooks(
                        *self._hooks(saved, cell, ins.get(si), enc)):
                    out = stage.fn(stage_params[si], *args)
                cells[si] = cell
            if sync:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - tin
            if saved is not None:
                profile = ModuleProfile(stage.name, _nbytes(saved), dt)
                if self.policy.should_offload(si, profile):
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
            else:
                x = out.detach().requires_grad_(True)
                ins[si + 1] = x
        self.tracker.mark(f"backward_begin_{tx.step_id}")
        bwd_begin = self.tracker.current
        dev_bwd_begin = (torch.cuda.memory_allocated(self.device)
                         if self.device.type == "cuda" else 0)
        loss_value = float(loss.detach())       # waits for the forward
        fwd_sp.__exit__(None, None, None)
        t_bwd = time.perf_counter()
        counts["forward_s"] += t_bwd - t_fwd
        bwd_sp = obs.span("engine.bwd", cat="engine", step=self._step, mb=mb)
        bwd_sp.__enter__()

        carry = torch.ones((), dtype=torch.float32, device=self.device)
        enc_grad = None          # d loss / d enc, summed over cross stages
        for si in range(len(self._stages) - 1, -1, -1):
            stage = self._stages[si]
            for s in reuse_horizon(range(si - 1, -1, -1)):
                tx.prefetch(s)
            leaves = tree_flatten(stage_params[si])[0]
            inputs = leaves + ([ins[si]] if si in ins else []) + (
                [enc] if stage.takes_enc else [])
            if si in recompute:
                got = self._recompute(stage, stage_params[si], batch, ins,
                                      enc, si, inputs, carry)
                self.tracker.free((tx.key(si), "k"),
                                  tag=f"ckpt_done:{tx.key(si)}")
            else:
                try:
                    fetched = tx.fetch(si)
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
                        got = torch.autograd.grad(outs[si], inputs, carry,
                                                  allow_unused=True)
                    finally:
                        # a backward that raises leaves its graph's saved
                        # tensors unpacked, and their unpack hook holds
                        # this cell: emptied, or the cell, graph and
                        # tensors keep each other alive past the step
                        cells[si].clear()
                    del fetched
                tx.drop(si)
            outs.pop(si)
            cells.pop(si, None)
            if stage.takes_enc:
                enc_grad = (got[-1] if enc_grad is None
                            else enc_grad + got[-1])
                got = got[:-1]
            if si in ins:
                carry = got[-1]
                ins.pop(si)
            elif stage.role == "embed" and enc is not None:
                # the decoder stream is done: enc_final's backward next
                carry, enc_grad, enc = enc_grad, None, None
            self._add_grads(grads, params, stage, stage_params[si],
                            got[:len(leaves)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        bwd_sp.__exit__(None, None, None)
        counts["backward_s"] += time.perf_counter() - t_bwd
        return loss_value, bwd_begin, dev_bwd_begin

    def _hooks(self, saved: list, cell: list, x_in=None, enc=None):
        """(pack, unpack) for one stage: saved tensors, minus parameters,
        views of the stage input `x_in` or of the encoder states `enc`
        and duplicates, collect in `saved`; unpack serves them from
        `cell`, which backward fills with the fetched list."""
        is_param = self.spool.registry.is_parameter
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
            return (True, pos)

        def unpack(h):
            stored, v = h
            return cell[v] if stored else v

        return pack, unpack

    @staticmethod
    def _args_for(stage: _Stage, batch, x, enc):
        if stage.role in ("enc_embed", "embed"):
            return (batch,)
        if stage.role == "head":
            return (x, batch["labels"])
        if stage.takes_enc:
            return (x, enc)
        return (x,)

    def _recompute(self, stage, p, batch, ins, enc, si, inputs, carry):
        """The stage's forward again, under autograd, then its backward
        (RecomputePolicy stages, and the fetch-failure fallback)."""
        with torch.enable_grad():
            out = stage.fn(p, *self._args_for(stage, batch, ins.get(si),
                                              enc))
            return torch.autograd.grad(out, inputs, carry,
                                       allow_unused=True)

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

    def close(self) -> None:
        """Idempotent: drain and join the spool (and remove the temp dir
        it created)."""
        if self._closed:
            return
        self._closed = True
        self.spool.close()
