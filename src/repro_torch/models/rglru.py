"""RG-LRU recurrent block (Griffin / recurrentgemma) of the port,
mirroring the JAX package's `repro/models/rglru.py`. [arXiv:2402.19427]

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates.

`apply_rglru(impl="torch")` runs the plain step-by-step recurrence
(`kernels/rglru_scan.py::rglru_sequential`) under autograd; `impl="cuda"`
runs `kernels.rglru_scan.rglru_scan`, the hand-written CUDA kernel with
its reverse-recurrence backward (on CPU tensors its plain version): the
port's counterpart of the JAX package's `impl="pallas"`. `decode_rglru`
is the one-token decode step of serving: the conv window and the f32
(B, W) state advance by one token, written into the cache IN PLACE.

Under a tensor axis (`tp`, `parallel/comm.py::TpGroup`) `apply_rglru`
runs this rank's share of the width W: its columns of `w_branch_gate`,
`w_in`, `w_a` and `w_i`, its channels of the conv, its rows of `w_out`
(the caller sums the output over the axis). The gates are products of
the whole conv output `u` with this rank's columns, so `u` is gathered
over the axis and its gradient reduce-scattered back
(`TpGroup.gather_partial`); `b_a`, `b_i`, `lambda_p` and the conv bias
are whole, each rank reading its slice after `grad_sum`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_sequential
from repro_torch.models.layers import (apply_conv1d, dense_init, gelu_tanh,
                                       init_conv1d, matmul_f32)

_C = 8.0  # Griffin's fixed gate temperature


def init_rglru(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    """The JAX package's leaves and distributions; b_a, b_i and lambda_p
    are float32 whatever the model dtype."""
    D = cfg.d_model
    W = cfg.rglru_width or D
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_branch_gate": dense_init(gen, lead + (D, W), D, dtype),
        "w_in": dense_init(gen, lead + (D, W), D, dtype),
        "conv": init_conv1d(gen, cfg.rglru_conv_width, W, dtype, lead),
        "w_a": dense_init(gen, lead + (W, W), W, dtype),
        "b_a": torch.zeros(lead + (W,), **f32),
        "w_i": dense_init(gen, lead + (W, W), W, dtype),
        "b_i": torch.zeros(lead + (W,), **f32),
        # softplus(lambda_p) ~ 0.3..1 -> slow decay at init
        "lambda_p": torch.full(lead + (W,), 0.5, **f32),
        "w_out": dense_init(gen, lead + (W, D), W, dtype),
    }


def tp_width(width: int, tp_size: int) -> int:
    """The RG-LRU width a rank of a tensor axis of `tp_size` runs; a
    ValueError when the axis does not divide it."""
    if width % tp_size:
        raise ValueError(f"a tensor axis of {tp_size} ranks does not divide "
                         f"the RG-LRU width {width}")
    return width // tp_size


def _gates(p, u, u_all=None):
    """u: (..., W) post-conv signal -> (log_a, scaled input), f32. Under
    a tensor axis `u` is this rank's share of the width and `u_all` the
    whole."""
    u32 = u.float()
    uw = u32 if u_all is None else u_all.float()
    r = torch.sigmoid(matmul_f32(uw, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(matmul_f32(uw, p["w_i"]) + p["b_i"])
    log_a = -_C * F.softplus(p["lambda_p"]) * r               # (..., W) < 0
    a2 = torch.exp(2.0 * log_a)
    scaled = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * u32)
    return log_a, scaled


def _rank_share(p, cfg: ModelConfig, tp):
    """`p` with the conv bias, `b_a`, `b_i` and `lambda_p` cut to this
    rank's share of the width (each whole on every rank, read after
    `grad_sum`)."""
    n = tp_width(cfg.rglru_width or cfg.d_model, tp.size)
    mine = slice(tp.rank * n, (tp.rank + 1) * n)
    conv_b, b_a, b_i, lam = (t[mine] for t in tp.grad_sum(
        p["conv"]["b"], p["b_a"], p["b_i"], p["lambda_p"]))
    return dict(p, conv={"w": p["conv"]["w"], "b": conv_b}, b_a=b_a,
                b_i=b_i, lambda_p=lam)


def apply_rglru(p, x, cfg: ModelConfig, *, impl: str = "torch", tp=None):
    """Training / prefill. x: (B, S, D) -> (y, cache). Under a tensor axis
    `tp` x is the parallel region's input (`TpGroup.enter`) and y this
    rank's partial sum of the output (see the module doc)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown rglru impl {impl!r} (torch | cuda)")
    gate = gelu_tanh((x @ p["w_branch_gate"]).float())
    u = x @ p["w_in"]
    if tp is not None:
        p = _rank_share(p, cfg, tp)
    u, conv_state = apply_conv1d(p["conv"], u)
    u_all = None if tp is None else tp.gather_partial(u, u.dim() - 1)
    log_a, scaled = _gates(p, u, u_all)
    h = (rglru_scan(log_a, scaled) if impl == "cuda"
         else rglru_sequential(log_a, scaled))
    y = (h * gate).to(x.dtype)
    out = y @ p["w_out"]
    return out, {"conv": conv_state, "h": h[:, -1]}


def decode_rglru(p, x1, cache, cfg: ModelConfig, *, tp=None):
    """One-token decode. x1: (B, 1, D); cache {"conv": (B, W-1, W),
    "h": (B, W) f32}, both advanced IN PLACE: h = exp(log_a) h + scaled,
    in f32. Under a tensor axis `tp` the cache and the output are this
    rank's share of the width, as `apply_rglru`'s are; the gates read the
    whole conv output, gathered over the axis (`TpGroup.all_gather`: no
    backward at serving)."""
    gate = gelu_tanh((x1 @ p["w_branch_gate"]).float())
    u = x1 @ p["w_in"]
    if tp is not None:
        p = _rank_share(p, cfg, tp)
    u, conv_state = apply_conv1d(p["conv"], u, cache["conv"])
    u_all = None if tp is None else tp.all_gather(u, u.dim() - 1)
    log_a, scaled = _gates(p, u, u_all)
    h = torch.exp(log_a[:, 0]) * cache["h"] + scaled[:, 0]    # (B, W)
    y = (h[:, None] * gate).to(x1.dtype)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return y @ p["w_out"]
