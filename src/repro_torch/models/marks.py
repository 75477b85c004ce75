"""The names the memory tiers place inside a layer: the port's counterpart
of the JAX package's `jax.ad_checkpoint.checkpoint_name` marks
("attn_out" in `repro/models/transformer.py::apply_block`, "mlp_hidden"
in `repro/models/layers.py::apply_mlp`, "moe_hidden" in
`repro/models/moe.py::_expert_ffn`).

A mark is the identity unless a tier is active on this thread:

  recording(names)   the engine's forward of a recomputed layer stage
                     (under `no_grad`): each mark of a name in `names`
                     appends (name, tensor) to the list it yields, which
                     the engine keeps on the device or moves to pinned
                     host memory until the stage's backward;
  replaying(names, held)
                     the stage's recompute: each such mark answers, in
                     the forward's order, with the held tensor, taken out
                     of `held` (the recompute's graph is then its only
                     holder, which frees it once its backward has read
                     it), so the recompute takes the held tensor where
                     the JAX recompute takes the residual.

`checkpoint_name(t, name)` marks a value its producers are recomputed
for anyway (the MLP's and the experts' hidden: the activation's backward
needs its input): in a replay it returns the held tensor, whose gradient
goes to `t`. `mark_output(name, run, vjp, *inputs)` marks the output of
`run(*inputs)`: in a replay `run` is not called at all, and the held
output's backward is `vjp(inputs, g)` (the attention's: its backward
needs only q, k and v, which the recompute has).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Sequence, Tuple

import torch

_TLS = threading.local()


class _Tier:
    """The active tier of this thread: `held` collects (recording) or
    hands out its first entry, and lets go of it (replaying)."""

    def __init__(self, names, held, replay: bool):
        self.names = frozenset(names)
        self.held = held
        self.replay = replay

    def take(self, name: str, shape) -> torch.Tensor:
        if not self.held:
            raise RuntimeError(f"the recompute marks {name!r} past the "
                               f"tensors its forward held")
        got, t = self.held[0]
        if got != name or tuple(t.shape) != tuple(shape):
            raise RuntimeError(
                f"the recompute marks {name!r} {tuple(shape)} where its "
                f"forward held {got!r} {tuple(t.shape)}")
        del self.held[0]
        return t


@contextlib.contextmanager
def _active(tier: _Tier):
    if getattr(_TLS, "tier", None) is not None:
        raise RuntimeError("a memory tier is already active on this thread")
    _TLS.tier = tier
    try:
        yield tier.held
    finally:
        _TLS.tier = None


def recording(names: Sequence[str]):
    """Within: the marks of `names` append (name, tensor) to the list
    this yields."""
    return _active(_Tier(names, [], replay=False))


def replaying(names: Sequence[str], held: List[Tuple[str, torch.Tensor]]):
    """Within: the marks of `names` answer with `held`'s tensors in
    order, each taken out of the list."""
    return _active(_Tier(names, held, replay=True))


def _tier_for(name: str):
    tier = getattr(_TLS, "tier", None)
    return tier if tier is not None and name in tier.names else None


class _HeldValue(torch.autograd.Function):
    """The held tensor in place of `t`; the gradient goes to `t`."""

    @staticmethod
    def forward(ctx, t, box):
        return box[0].detach()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _HeldOutput(torch.autograd.Function):
    """The held output of `run(*inputs)`; its backward is `vjp`."""

    @staticmethod
    def forward(ctx, vjp, box, *inputs):
        ctx.vjp = vjp
        ctx.save_for_backward(*inputs)
        return box[0].detach()

    @staticmethod
    def backward(ctx, g):
        return (None, None, *ctx.vjp(ctx.saved_tensors, g))


def checkpoint_name(t: torch.Tensor, name: str) -> torch.Tensor:
    """`t`, marked `name` (the module docstring)."""
    tier = _tier_for(name)
    if tier is None:
        return t
    if not tier.replay:
        tier.held.append((name, t))
        return t
    return _HeldValue.apply(t, [tier.take(name, t.shape)])


def mark_output(name: str, run: Callable, vjp: Callable, *inputs
                ) -> torch.Tensor:
    """`run(*inputs)`, marked `name`; in a replay the held output, whose
    shape is the first input's, with backward `vjp(inputs, g)`."""
    tier = _tier_for(name)
    if tier is None:
        return run(*inputs)
    if not tier.replay:
        out = run(*inputs)
        tier.held.append((name, out))
        return out
    held = tier.take(name, inputs[0].shape)
    return _HeldOutput.apply(vjp, [held], *inputs)


def vjp_of(fn: Callable, inputs, g) -> Tuple:
    """The VJP of `fn` at `inputs` against `g`, `fn` recomputed under
    autograd."""
    xs = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        out = fn(*xs)
        return torch.autograd.grad(out, xs, g)
