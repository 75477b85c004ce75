"""Mixture-of-Experts FFN of the port: the JAX package's
`repro/models/moe.py`, its local path and its expert-parallel one.

Routing is a full softmax over the experts in f32, then top-k,
renormalised (Mixtral-style); the aux losses are Switch's load balance
and the router z-loss, over the global batch: on a mesh the router's
per-expert sums, the z-loss sum and the row count are summed over the dp
axes (`parallel/comm.py::sum_over`) before the means are taken.

Dispatch is JAX's layout: a (E_local, C, D) buffer where routed row j of
local expert e sits at (e, rank of j within e), the rank taken over all
E experts in row order. Each slot is written once, by `index_copy_` (its
backward an `index_select`), and read back once, by `index_select`, so
neither direction adds into a slot and the results do not depend on the
order of a scatter. A row routed to another rank's expert, or ranked at
or past the capacity C, is dropped: it writes a spare slot past the
buffer and reads row 0 with weight 0 (JAX reads a zero pad row; both
give 0; `dropped_rows` counts the rows a capacity drops). The shapes
do not depend on the routing, so the one-device
layer also runs on the meta device (the exact residual counter,
`core/endurance.py`). The expert FFN is three batched products over all
E_local*C rows, zero rows included, as in JAX.

Three paths, one body (`_moe_shard_body`):

  * one device (no mesh, or no `ep_axis` and experts whole on the rank):
    every expert, capacity B*S: dropless, so a token's output never
    depends on the rest of the batch, and a full-sequence forward, a
    prefill and a decode step give each token the same output;
  * a mesh without `ep_axis` (what the JAX session runs; GSPMD computes
    the one-device function): `param_specs` splits the experts over the
    tensor axis, so each rank runs its E/tp experts over all of its
    local rows at capacity = its local rows (still dropless), and the
    sum over the axis completes the output;
  * `ep_axis` on a mesh (JAX's shard_map path): the same split with
    GShard's capacity ceil(local_tokens*k/E*capacity_factor), where
    local_tokens = B*S/dp, so rows past it are dropped.

On a split the block input enters the parallel region (`TpGroup.enter`:
the gradient of the dispatched rows is summed over the axis), the
routing weights are replicated values read inside it
(`TpGroup.grad_sum`), and the partial outputs are summed in rank order
(`TpGroup.reduce`, the same bits on every rank). The router and its
statistics stay outside the region, the same on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import activation, dense_init
from repro_torch.models.marks import checkpoint_name
from repro_torch.parallel.comm import axis_group, sum_over


@dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"


def init_moe(gen, d_model, d_ff, num_experts, dtype, lead=()):
    """router (D, E) in f32, w_in / w_gate (E, D, F), w_out (E, F, D),
    each with leading dims `lead`."""
    lead = tuple(lead)
    E = num_experts
    return {
        "router": dense_init(gen, lead + (d_model, E), d_model,
                             torch.float32),
        "w_in": dense_init(gen, lead + (E, d_model, d_ff), d_model, dtype),
        "w_gate": dense_init(gen, lead + (E, d_model, d_ff), d_model, dtype),
        "w_out": dense_init(gen, lead + (E, d_ff, d_model), d_ff, dtype),
    }


def _expert_starts(sorted_eids, num_experts):
    """Index of each expert's first row in the sorted expert ids, and
    one past its last (no scatter-add: a search of the sorted ids)."""
    ids = torch.arange(num_experts, dtype=sorted_eids.dtype,
                       device=sorted_eids.device)
    return (torch.searchsorted(sorted_eids, ids),
            torch.searchsorted(sorted_eids, ids, right=True))


def _route(x, router_w, settings: MoESettings, comm=None, dp_axes=()):
    """x: (T, D). Returns (eids (T, k) int64, weights (T, k) f32, aux
    losses {"moe_lb", "moe_z"}); with `comm` and `dp_axes` the aux
    losses are those of the rows of every rank of the dp axes."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_p, eids = torch.topk(probs, settings.top_k, dim=-1)
    weights = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    E = settings.num_experts
    lo, hi = _expert_starts(torch.sort(eids.reshape(-1)).values, E)
    lse2 = torch.logsumexp(logits, dim=-1).square()
    if comm is None or comm.size(dp_axes) == 1:
        me = probs.mean(dim=0)                                 # (E,)
        ce = (hi - lo).float() / eids.numel()
        z_loss = lse2.mean()
    else:
        # sum(me)/T, counts/(T*k) and sum(lse^2)/T over the global rows
        rows = torch.full((1,), float(x.shape[0]), device=x.device)
        tot = sum_over(torch.cat([probs.sum(dim=0), (hi - lo).float(),
                                  lse2.sum().reshape(1), rows]),
                       comm, dp_axes)
        n = tot[-1]
        me = tot[:E] / n
        ce = tot[E:2 * E] / (n * settings.top_k)
        z_loss = tot[2 * E] / n
    lb_loss = E * torch.sum(me * ce)
    return eids, weights, {"moe_lb": lb_loss, "moe_z": z_loss}


def _expert_ranks(eids_flat, num_experts):
    """Rank of each routed row within its expert, in row order (a stable
    sort, as JAX's)."""
    tk = eids_flat.shape[0]
    order = torch.argsort(eids_flat, stable=True)
    sorted_e = eids_flat[order]
    starts, _ = _expert_starts(sorted_e, num_experts)
    rank_sorted = torch.arange(tk, device=eids_flat.device) - starts[sorted_e]
    rank = torch.empty_like(eids_flat)
    rank[order] = rank_sorted
    return rank


def _expert_ffn(buf, w_in, w_gate, w_out, act_name):
    """buf: (E, C, D) -> (E, C, D): act(buf w_gate) * (buf w_in) w_out per
    expert."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    # the memory tiers' "moe_hidden" (`models/marks.py`)
    h = checkpoint_name(activation(act_name)(g) * h, "moe_hidden")
    return torch.bmm(h, w_out)


class _DropCount:
    """Assignments `_moe_shard_body` dropped at the capacity (rows of this
    rank's experts ranked at or past it), summed on the device so the
    forward does not wait for it; each forward that runs the body counts,
    a recomputed one too. `reset()` sets it to 0, `read()` waits."""

    def __init__(self):
        self.total = None

    def add(self, n: torch.Tensor) -> None:
        if n.device.type != "meta":
            self.total = n if self.total is None else self.total + n

    def reset(self) -> None:
        self.total = None

    def read(self) -> int:
        return 0 if self.total is None else int(self.total)


dropped_rows = _DropCount()


def _moe_shard_body(x, ef, rank, weights, w_in, w_gate, w_out, *,
                    settings: MoESettings, e0: int, num_local: int,
                    capacity: int):
    """One rank's MoE output over its experts e0 .. e0+num_local. x: (T, D)
    local rows; ef, rank: (T*k,) expert ids and their global ranks;
    weights: (T, k). Assignments to other experts, and ranks at or past
    `capacity`, are dropped."""
    T, D = x.shape
    k = settings.top_k
    n = num_local * capacity
    le = ef - e0
    here = (le >= 0) & (le < num_local)
    keep = here & (rank < capacity)
    dropped_rows.add(here.sum() - keep.sum())
    slot = torch.where(keep, le * capacity + rank, n)          # spare slot
    rd = torch.where(keep, slot, 0)
    weights = torch.where(keep.view_as(weights), weights, 0.0)
    buf = x.new_zeros((n + 1, D))
    xk = x.unsqueeze(1).expand(T, k, D).reshape(T * k, D)
    buf.index_copy_(0, slot, xk)
    out = _expert_ffn(buf[:n].view(num_local, capacity, D), w_in, w_gate,
                      w_out, settings.act).reshape(n, D)
    yk = out.index_select(0, rd) * weights.reshape(-1, 1).to(x.dtype)
    return yk.view(T, k, D).sum(dim=1)


def apply_moe(params, x, settings: MoESettings, *, mesh=None,
              ep_axis: Optional[str] = None, dp_axes: Tuple[str, ...] = (),
              tp_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D), this rank's rows on a mesh -> (y (B, S, D), {"moe_lb",
    "moe_z"}): each token's output is the routing-weighted sum of its k
    experts' outputs (the module docstring's three paths). `tp_axis`
    (the port's own keyword): the axis `param_specs` splits the experts
    over when `ep_axis` is None; with `ep_axis` the experts must be
    split over it."""
    B, S, D = x.shape
    T, E, k = B * S, settings.num_experts, settings.top_k
    ep = mesh is not None and ep_axis is not None
    if ep and E % mesh.shape[ep_axis]:
        raise ValueError(f"{E} experts do not split over {ep_axis!r} of "
                         f"{mesh.shape[ep_axis]}")
    here = params["w_in"].shape[0]
    grp = axis_group(mesh, ep_axis or tp_axis) if here != E else None
    if here != E and (grp is None or grp.size * here != E):
        raise ValueError(f"{here} of {E} experts on this rank, and no "
                         f"mesh axis splits them so")
    xf = x.reshape(T, D)
    comm = mesh.comm if mesh is not None else None
    dp = (tuple(a for a in dp_axes if mesh.shape[a] > 1)
          if mesh is not None else ())
    eids, weights, aux = _route(xf, params["router"], settings, comm, dp)
    ef = eids.reshape(-1)                                       # (T*k,)
    rank = _expert_ranks(ef, E)
    # GShard: ceil(local_tokens * k / E * capacity_factor)
    capacity = (int(math.ceil(T * k / E * settings.capacity_factor)) if ep
                else T)
    if grp is None:
        y = _moe_shard_body(xf, ef, rank, weights, params["w_in"],
                            params["w_gate"], params["w_out"],
                            settings=settings, e0=0, num_local=E,
                            capacity=capacity)
    else:
        y = grp.reduce(_moe_shard_body(
            grp.enter(xf), ef, rank, grp.grad_sum(weights), params["w_in"],
            params["w_gate"], params["w_out"], settings=settings,
            e0=grp.rank * here, num_local=here, capacity=capacity))
    return y.view(B, S, D), aux
