"""Pipeline parallelism: the JAX package's GPipe fill-drain schedule
(`repro/parallel/pipeline.py`) over a "pipe" axis of ranks.

At tick t, stage s runs microbatch m = t - s (when 0 <= m < M), for
T = M + S - 1 ticks; a stage's output goes to the next stage by
`Comm.send` / `Comm.recv`, and the last stage collects the (M, mb, ...)
outputs, which every rank then receives (`Comm.broadcast`), as JAX's
`out[-1]` is replicated. Where JAX runs a stage on every tick and masks
the inactive ones, a rank here skips them: the same values, no idle
compute or traffic.

The backward is the drain run explicitly, in one `torch.autograd.Function`
around the whole schedule: the ticks in reverse, each stage receiving the
gradient of its microbatch's output from the next stage, running that
microbatch's backward and sending the gradient of its input to the
previous stage. Left to autograd, the M microbatch chains would reach
their sends and receives in no fixed order across ranks and could
deadlock. The gradient of the outputs is the last stage's (every rank
computes the same loss head on the same outputs, and JAX's cotangent
reaches only the last stage's collection); the gradient of the input
microbatches is stage 0's, sent to every rank when the input requires
one. Each rank ends with its own stage's parameter gradient: JAX's
`g_pipe[s]`.

Memory is GPipe's: each stage holds the graphs of its M microbatches
from the fill to the drain.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten


def _stage_slice(params_stacked, mesh, axis: str):
    """This rank's stage's parameters: the slice at its index on `axis` of
    leaves stacked over every stage."""
    n, sid = mesh.shape[axis], mesh.coords[axis]

    def one(leaf):
        if leaf.shape[0] != n:
            raise ValueError(f"a stacked leaf of {leaf.shape[0]} stages on "
                             f"a pipe of {n}")
        return leaf[sid]
    leaves, tdef = tree_flatten(params_stacked)
    return tree_unflatten(tdef, [one(t) for t in leaves])


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tdef, mesh, axis, x_mb, *leaves):
        comm = mesh.comm
        S, sid = mesh.shape[axis], mesh.coords[axis]
        M = x_mb.shape[0]
        act_shape, dev = tuple(x_mb.shape[1:]), x_mb.device
        params = tree_unflatten(tdef, [
            t.detach().requires_grad_(t.requires_grad) for t in leaves])
        plist = tree_flatten(params)[0]
        ins, outs = [None] * M, [None] * M
        collected = torch.empty_like(x_mb) if sid == S - 1 else None
        for t in range(M + S - 1):
            m = t - sid
            if not 0 <= m < M:
                continue
            if sid == 0:
                x_in = x_mb[m].detach()
            else:
                x_in = comm.recv(act_shape, x_mb.dtype, dev, axis, sid - 1)
            x_in.requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(params, x_in)
            ins[m], outs[m] = x_in, y
            if sid < S - 1:
                comm.send(y.detach(), axis, sid + 1)
            else:
                collected[m].copy_(y.detach())
        ctx.mesh, ctx.axis = mesh, axis
        ctx.ins, ctx.outs, ctx.plist = ins, outs, plist
        ctx.x_needs_grad = x_mb.requires_grad
        ctx.meta = (M, act_shape, x_mb.dtype, dev)
        return comm.broadcast(collected, axis, S - 1, shape=x_mb.shape,
                              dtype=x_mb.dtype, device=dev)

    @staticmethod
    def backward(ctx, g_out):
        comm, axis = ctx.mesh.comm, ctx.axis
        S, sid = ctx.mesh.shape[axis], ctx.mesh.coords[axis]
        M, act_shape, dtype, dev = ctx.meta
        plist = ctx.plist
        wants = [p.requires_grad for p in plist]
        grads: List[Any] = [None] * len(plist)
        dx = torch.zeros((M,) + act_shape, dtype=dtype, device=dev) \
            if sid == 0 and ctx.x_needs_grad else None
        for t in range(M + S - 2, -1, -1):
            m = t - sid
            if not 0 <= m < M:
                continue
            if sid == S - 1:
                dy = g_out[m]
            else:
                dy = comm.recv(act_shape, dtype, dev, axis, sid + 1)
            inputs = [ctx.ins[m]] + [p for p, w in zip(plist, wants) if w]
            got = torch.autograd.grad(ctx.outs[m], inputs, dy,
                                      allow_unused=True)
            ctx.outs[m] = ctx.ins[m] = None
            gx, gps = got[0], iter(got[1:])
            for i, w in enumerate(wants):
                if not w:
                    continue
                g = next(gps)
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if sid > 0:
                comm.send(gx, axis, sid - 1)
            elif dx is not None:
                dx[m] = gx
        if ctx.x_needs_grad:
            dx = comm.broadcast(dx, axis, 0, shape=(M,) + act_shape,
                                dtype=dtype, device=dev)
        return (None, None, None, None, dx,
                *[None if g is None and not w else
                  (torch.zeros_like(p) if g is None else g)
                  for g, w, p in zip(grads, wants, plist)])


def pipeline_apply(stage_fn: Callable, params_stacked, x_mb, mesh,
                   axis: str = "pipe"):
    """Run microbatches through a stage pipeline.

    stage_fn(stage_params, x) -> y        (same shape as x)
    params_stacked: a tree whose leaves have a leading dim of n_stages
        (this rank runs its slice)
    x_mb: (M, mb, ...) microbatched input (stage 0 reads it)
    Returns (M, mb, ...) outputs of the final stage, on every rank.
    """
    leaves, tdef = tree_flatten(_stage_slice(params_stacked, mesh, axis))
    return _Pipeline.apply(stage_fn, tdef, mesh, axis, x_mb, *leaves)


def pipeline_loss_fn(stage_fn: Callable, loss_head: Callable, mesh,
                     axis: str = "pipe"):
    """Compose pipeline_apply with a loss head into a grad-able scalar fn:
    loss(params_stacked, x_mb, batch_aux) -> scalar."""

    def loss(params_stacked, x_mb, aux):
        y = pipeline_apply(stage_fn, params_stacked, x_mb, mesh, axis)
        return loss_head(y, aux)

    return loss


__all__ = ["pipeline_apply", "pipeline_loss_fn"]
