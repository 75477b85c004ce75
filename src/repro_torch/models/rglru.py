"""RG-LRU recurrent block (Griffin / recurrentgemma) of the port,
mirroring the JAX package's `repro/models/rglru.py` (training / prefill
path). [arXiv:2402.19427]

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates.

`apply_rglru(impl="torch")` runs the plain step-by-step recurrence
(`kernels/rglru_scan.py::rglru_sequential`) under autograd; `impl="cuda"`
runs `kernels.rglru_scan.rglru_scan`, the hand-written CUDA kernel with
its reverse-recurrence backward (on CPU tensors its plain version): the
port's counterpart of the JAX package's `impl="pallas"`. The one-token
decode (`decode_rglru`) belongs to serving the hybrid and is not ported
yet.
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


def _gates(p, u):
    """u: (..., W) post-conv signal -> (log_a, scaled input), f32."""
    u32 = u.float()
    r = torch.sigmoid(matmul_f32(u32, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(matmul_f32(u32, p["w_i"]) + p["b_i"])
    log_a = -_C * F.softplus(p["lambda_p"]) * r               # (..., W) < 0
    a2 = torch.exp(2.0 * log_a)
    scaled = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * u32)
    return log_a, scaled


def apply_rglru(p, x, cfg: ModelConfig, *, impl: str = "torch"):
    """Training / prefill. x: (B, S, D) -> (y, cache)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown rglru impl {impl!r} (torch | cuda)")
    gate = gelu_tanh((x @ p["w_branch_gate"]).float())
    u = x @ p["w_in"]
    u, conv_state = apply_conv1d(p["conv"], u)
    log_a, scaled = _gates(p, u)
    h = (rglru_scan(log_a, scaled) if impl == "cuda"
         else rglru_sequential(log_a, scaled))
    y = (h * gate).to(x.dtype)
    out = y @ p["w_out"]
    return out, {"conv": conv_state, "h": h[:, -1]}
