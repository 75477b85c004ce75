"""Shared building blocks of the port (forward only), mirroring the JAX
package's `repro/models/layers.py`.

Parameters are plain tensors in nested dicts with the JAX pytree keys.
The `torch.autograd.Function` forms of rms_norm and GELU that save only
their inputs belong to the training slice; serving needs the forward.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


# ---------------------------------------------------------------- init
#
# Same distributions as the JAX package's dense_init / embed_init (a
# normal truncated at +-2 sigma, fan-in std, 0.02 for embeddings). The
# random stream cannot match jax.random's; tests hand both packages one
# set of weights through models/convert.py instead.

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Phi(2)


def truncated_normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] by inverse-CDF sampling, in
    f32 on the generator's device, cast to `dtype`."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    u = u.mul_(_HI - _LO).add_(_LO).mul_(2.0).sub_(1.0)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.to(dtype)


def dense_init(gen, shape, in_axis_size, dtype) -> torch.Tensor:
    u = truncated_normal(gen, shape, torch.float32)
    return u.mul_(1.0 / math.sqrt(in_axis_size)).to(dtype)


def embed_init(gen, shape, dtype) -> torch.Tensor:
    return truncated_normal(gen, shape, torch.float32).mul_(0.02).to(dtype)


# ---------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float):
    """RMSNorm with the (1 + scale) convention (scale stored as
    "scale - 1", so zeros are the identity), in f32, cast back."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_norm(d, dtype, device, lead=()) -> Params:
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                 device=device)}


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-halves RoPE in f32. x: (..., S, H, D); positions:
    broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- misc


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


# ---------------------------------------------------------------- MLP


def init_mlp(gen, d_model, d_ff, dtype, lead=()) -> Params:
    lead = tuple(lead)
    return {
        "w_in": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w_out": dense_init(gen, lead + (d_ff, d_model), d_ff, dtype),
    }


def apply_mlp(p: Params, x):
    """The classic (non-gated) 2-layer GELU MLP of the paper's GPT."""
    return gelu(x @ p["w_in"]) @ p["w_out"]
