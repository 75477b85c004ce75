"""Mixture-of-Experts FFN of the port: the JAX package's
`repro/models/moe.py` on its local, dropless path.

Routing is a full softmax over the experts in f32, then top-k,
renormalised (Mixtral-style); the aux losses are Switch's load balance
and the router z-loss. Every routed row goes to its expert (capacity
B*S: an expert takes at most one row of each token), so a token's output
never depends on the rest of the batch, and a full-sequence forward, a
prefill and a decode step give each token the same output.

Dispatch is JAX's layout: an (E, B*S, D) buffer where routed row j of
expert e sits at (e, rank of j within e). Each (expert, rank) slot is
written once, by `index_copy` (its backward an `index_select`), and read
back once, by `index_select`, so neither direction adds into a slot and
the results do not depend on the order of a scatter. The shapes do not
depend on the routing, so the layer also runs on the meta device (the
exact residual counter, `core/endurance.py`). The expert FFN is three
batched products over all E*B*S rows, zero rows included, as in JAX.

The expert-parallel shard_map path waits for slice 12b of meshes
(ROADMAP §1 item 12): `apply_moe` raises when it is given one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import activation, dense_init


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


def _route(x, router_w, settings: MoESettings):
    """x: (T, D). Returns (eids (T, k) int64, weights (T, k) f32, aux
    losses {"moe_lb", "moe_z"})."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_p, eids = torch.topk(probs, settings.top_k, dim=-1)
    weights = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    E = settings.num_experts
    me = probs.mean(dim=0)                                     # (E,)
    lo, hi = _expert_starts(torch.sort(eids.reshape(-1)).values, E)
    ce = (hi - lo).float() / eids.numel()
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
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
    return torch.bmm(activation(act_name)(g) * h, w_out)


def apply_moe(params, x, settings: MoESettings, *, mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y (B, S, D), {"moe_lb", "moe_z"}): each token's
    output is the routing-weighted sum of its k experts' outputs."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism over a mesh waits "
                                  "for slice 12b (ROADMAP §1 item 12)")
    B, S, D = x.shape
    T, E, k = B * S, settings.num_experts, settings.top_k
    xf = x.reshape(T, D)
    eids, weights, aux = _route(xf, params["router"], settings)
    ef = eids.reshape(-1)                                       # (T*k,)
    slot = ef * T + _expert_ranks(ef, E)
    xk = xf.unsqueeze(1).expand(T, k, D).reshape(T * k, D)
    buf = xf.new_zeros((E * T, D)).index_copy(0, slot, xk)
    out = _expert_ffn(buf.view(E, T, D), params["w_in"], params["w_gate"],
                      params["w_out"], settings.act).reshape(E * T, D)
    yk = out.index_select(0, slot) * weights.reshape(-1, 1).to(x.dtype)
    return yk.view(T, k, D).sum(dim=1).view(B, S, D), aux
