"""Optimizers of the port, after the JAX package's
`repro/optim/optimizers.py`: sgd (with optional momentum) and adamw with
global-norm clipping, moments in float32, the same order of operations.

The port updates IN PLACE where the JAX package returns new trees:
parameters, moments and (when clipping) gradients are overwritten, leaf
by leaf and in slices of at most `CHUNK` elements along the leading
dimension, so the float32 temporaries of a 2.9 B-parameter model stay a
few hundred MB instead of several copies of the model. The math of each
element is unchanged by the slicing.

On a mesh each rank's `params` are its shards (`parallel/sharding.py::
param_specs(fsdp=True)`), so the moments `init` makes are that rank's
share, laid out as `spec_tree_for_optstate` says (ZeRO: the moments
inherit the parameters' specs); `zero1_shardings` is the JAX package's
rule for moments of unsharded parameters. The update then needs the
squared global norm over the whole mesh, which the engine hands it as
`update(..., sq_norm=fn)` (a rank's sum counts each replicated leaf
once).

Each optimizer also has the JAX package's `clip_norm` (the global-norm
threshold its fused `update` applies; None: off) and `leaf_update`, the
per-leaf kernel `(p, m, v, g, step) -> (new_p, new_m, new_v)` that the
optimizer overlap (`repro_torch.optim.overlap`) runs per layer. `step`
is the post-increment step (`state.step + 1`); `m` / `v` are None for an
optimizer without that moment. It returns new tensors and is the very
function the fused `update` applies to each slice, so one layer's
update is bitwise equal to that layer's slice of the fused update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

#: elements per in-place update slice
CHUNK = 1 << 26


class OptState(NamedTuple):
    step: int
    mu: Any        # first moment (AdamW) or momentum (SGD); None if off
    nu: Any        # second moment (AdamW only)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    #: update(grads, state, params) -> (params, state), in place
    update: Callable[[Any, OptState, Any], Any]
    name: str = "opt"
    #: global-norm clip threshold of `update` (None: off); eager
    #: per-layer updates are valid only without one
    clip_norm: Optional[float] = None
    #: per-leaf kernel (p, m, v, g, step) -> (new_p, new_m, new_v)
    leaf_update: Optional[Callable] = None


def _slices(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of `t` along dim 0 of at most CHUNK elements each."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // max(1, t[0].numel()))
    return list(t.split(rows))


def _zipped(*trees):
    """Matching slices of matching leaves of several trees."""
    leaves = [tree_flatten(t)[0] for t in trees]
    for group in zip(*leaves):
        yield from zip(*(_slices(t) for t in group))


def _zeros_f32(params):
    leaves, tdef = tree_flatten(params)
    return tree_unflatten(tdef, [torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                                 for p in leaves])


def global_norm(grads, sq_norm=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2) in float32 (`sq_norm`:
    the squared norm of a tree sharded over a mesh)."""
    if sq_norm is not None:
        return torch.sqrt(sq_norm(grads))
    total = None
    for leaf in tree_flatten(grads)[0]:
        s = sum(g.float().square().sum() for g in _slices(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float,
                        sq_norm=None) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / norm); returns
    the norm."""
    gn = global_norm(grads, sq_norm)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for (g,) in _zipped(grads):
        g.copy_(g.float() * scale)
    return gn


def sgd(lr: float = 1e-3, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_f32(params) if momentum else None, None)

    def leaf_update(p, m, v, g, step):
        del v, step
        if momentum:
            m = momentum * m + g.float()
            u = m
        else:
            m, u = None, g.float()
        return (p.float() - lr * u).to(p.dtype), m, None

    def update(grads, state, params, *, sq_norm=None):
        if clip_norm:
            clip_by_global_norm(grads, clip_norm, sq_norm)
        if momentum:
            for p, m, g in _zipped(params, state.mu, grads):
                new_p, new_m, _ = leaf_update(p, m, None, g, None)
                m.copy_(new_m)
                p.copy_(new_p)
        else:
            for p, g in _zipped(params, grads):
                p.copy_(leaf_update(p, None, None, g, None)[0])
        return params, OptState(state.step + 1, state.mu, None)

    return Optimizer(init, update, "sgd", clip_norm=clip_norm,
                     leaf_update=leaf_update)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0,
          warmup_steps: int = 0) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_f32(params), _zeros_f32(params))

    def leaf_update(p, m, v, g, step):
        sched = min(1.0, step / max(warmup_steps, 1)) if warmup_steps \
            else 1.0
        lr_t = lr * sched
        # bias corrections in float32, as the JAX package computes them
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32.square()
        del g32
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        u = u + weight_decay * p32
        return (p32 - lr_t * u).to(p.dtype), m, v

    def update(grads, state, params, *, sq_norm=None):
        if clip_norm:
            clip_by_global_norm(grads, clip_norm, sq_norm)
        step = state.step + 1
        for p, m, v, g in _zipped(params, state.mu, state.nu, grads):
            new_p, new_m, new_v = leaf_update(p, m, v, g, step)
            m.copy_(new_m)
            v.copy_(new_v)
            p.copy_(new_p)
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init, update, "adamw", clip_norm=clip_norm,
                     leaf_update=leaf_update)


def zero1_shardings(params_specs, dp_axes: Tuple[str, ...]):
    """ZeRO-1 (the JAX package's `repro/optim/optimizers.py:140-154`):
    shard each moment over the data axes on its parameter's first
    unsharded dimension (a replicated scalar's spec shards dim 0; a leaf
    sharded on every dim keeps its own spec)."""
    from repro_torch.parallel.sharding import map_with_path

    def shard_one(_, spec):
        parts = list(spec) if spec else []
        if not parts:
            return (dp_axes,)
        for i, p_ in enumerate(parts):
            if p_ is None:
                parts[i] = dp_axes
                return tuple(parts)
        return tuple(parts)

    return map_with_path(shard_one, params_specs)
