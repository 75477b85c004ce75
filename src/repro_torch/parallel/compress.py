"""Int8 error-feedback gradient compression for the dp mean, the JAX
package's `repro/parallel/compress.py` (off by default there too).

Scheme, per leaf:
  1. e += g                      (fold in the error-feedback residual)
  2. q = round(e / scale), scale = max|e| / 127 (floor 1e-20), rounded
     half to even and clipped to +-127, int8
  3. e  = e - q * scale          (the new residual: what q lost)
  4. all-gather (q, scale) over the dp axis, dequantize, mean in the
     axis's index order

The all-gather is one message a call: every leaf's f32 scale (as 4
bytes) and int8 q packed into one uint8 buffer, gathered by
`Comm.all_gather` (host-staged under gloo, direct under NCCL). Wire
cost per rank: N bytes + 4 per leaf, against 4N for an f32 all-reduce.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten


def init_error_state(grads_like) -> Any:
    """Zero residuals, f32, shaped like the gradients."""
    leaves, tdef = tree_flatten(grads_like)
    return tree_unflatten(tdef, [torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                                 for g in leaves])


def _quantize(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = (e.abs().max() / 127.0).clamp_min(1e-20)
    q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _pack(qs: List[torch.Tensor], scales: List[torch.Tensor]
          ) -> torch.Tensor:
    """The scales' bytes, then every leaf's q, as one uint8 vector padded
    to a multiple of 4 bytes (so each member's scales read as f32)."""
    parts = [torch.stack(scales).view(torch.uint8)]
    parts += [q.reshape(-1).view(torch.uint8) for q in qs]
    n = sum(p.numel() for p in parts)
    if n % 4:
        parts.append(parts[0].new_zeros(4 - n % 4))
    return torch.cat(parts)


def compressed_mean_grads(grads, err_state, mesh, axis: str):
    """Mean per-rank gradients over the dp `axis` with int8 error
    feedback. grads / err_state: trees of this rank's (unreduced)
    gradients and residuals. Returns (mean_grads, new_err_state), the
    means the same on every member of the axis."""
    g_leaves, tdef = tree_flatten(grads)
    e_leaves = tree_flatten(err_state)[0]
    qs, scales, errs = [], [], []
    for g, e in zip(g_leaves, e_leaves):
        e = e + g.float()
        q, scale = _quantize(e)
        qs.append(q)
        scales.append(scale)
        errs.append(e - q.float() * scale)
    parts = mesh.comm.all_gather(_pack(qs, scales), (axis,))
    off = 4 * len(qs)
    means = []
    for i, g in enumerate(g_leaves):
        total = None
        for buf in parts:
            scale = buf[:4 * len(qs)].view(torch.float32)[i]
            deq = buf[off:off + g.numel()].view(torch.int8).float() * scale
            total = deq if total is None else total + deq
        off += g.numel()
        means.append((total / len(parts)).view(g.shape).to(g.dtype))
    return tree_unflatten(tdef, means), tree_unflatten(tdef, errs)


def exact_mean_grads(grads, mesh, axis: str):
    """The f32 all-reduce mean that compression replaces (summed in the
    axis's index order)."""
    leaves, tdef = tree_flatten(grads)
    n = mesh.shape[axis]
    return tree_unflatten(tdef, [
        (mesh.comm.all_reduce_sum(g.float(), (axis,)) / n).to(g.dtype)
        for g in leaves])


__all__ = ["compressed_mean_grads", "exact_mean_grads", "init_error_state"]
