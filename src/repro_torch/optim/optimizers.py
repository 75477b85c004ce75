"""Optimizers of the port, after the JAX package's
`repro/optim/optimizers.py`: sgd (with optional momentum) and adamw with
global-norm clipping, moments in float32, the same order of operations.

The port updates IN PLACE where the JAX package returns new trees:
parameters, moments and (when clipping) gradients are overwritten, leaf
by leaf and in slices of at most `CHUNK` elements along the leading
dimension, so the float32 temporaries of a 2.9 B-parameter model stay a
few hundred MB instead of several copies of the model. The math of each
element is unchanged by the slicing. ZeRO-1 sharding waits for the
multi-GPU slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional

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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2) in float32."""
    total = None
    for leaf in tree_flatten(grads)[0]:
        s = sum(g.float().square().sum() for g in _slices(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / norm); returns
    the norm."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for (g,) in _zipped(grads):
        g.copy_(g.float() * scale)
    return gn


def sgd(lr: float = 1e-3, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_f32(params) if momentum else None, None)

    def update(grads, state, params):
        if clip_norm:
            clip_by_global_norm(grads, clip_norm)
        if momentum:
            for p, m, g in _zipped(params, state.mu, grads):
                m.copy_(momentum * m + g.float())
                p.copy_(p.float() - lr * m)
        else:
            for p, g in _zipped(params, grads):
                p.copy_(p.float() - lr * g.float())
        return params, OptState(state.step + 1, state.mu, None)

    return Optimizer(init, update, "sgd")


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0,
          warmup_steps: int = 0) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_f32(params), _zeros_f32(params))

    def update(grads, state, params):
        if clip_norm:
            clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        sched = min(1.0, step / max(warmup_steps, 1)) if warmup_steps \
            else 1.0
        lr_t = lr * sched
        # bias corrections in float32, as the JAX package computes them
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        for p, m, v, g in _zipped(params, state.mu, state.nu, grads):
            g32 = g.float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.float()
            u = u + weight_decay * p32
            p.copy_(p32 - lr_t * u)
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init, update, "adamw")
