"""Shared building blocks of the port, mirroring the JAX package's
`repro/models/layers.py`.

Parameters are plain tensors in nested dicts with the JAX pytree keys.
rms_norm, GELU (exact and tanh-approximate) and SiLU are
`torch.autograd.Function`s that save only their inputs and recompute the
rest in backward, with the JAX package's backward formulas (its
`custom_vjp` rules, `layers.py:34-75, 144-182`; the tanh form is the
derivative of `jax.nn.gelu(approximate=True)`): the composite forms would
save every primitive intermediate, and the saved tensors are what the
training engine sends to the SSD. The depthwise causal conv1d is a
Function for the same reason (the composite saves one shifted view of
the padded input per tap), and so is `matmul_f32` (the f32 copy of a
bf16 weight would be saved, and spooled, as if it were an activation).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.marks import checkpoint_name

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
    """Standard normal truncated to [-2, 2] by inverse-CDF sampling
    (`ndtri` of a uniform on [Phi(-2), Phi(2)]), in f32 on the
    generator's device, cast to `dtype`. Not through `erfinv`: on the
    CPU torch computes it with MKL's vector math, whose first call in a
    process, split over OpenMP threads, can return one thread's share at
    a lower accuracy (hundreds of ulps), so two runs from one seed would
    not start from the same weights."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    x = torch.special.ndtri(u.mul_(_HI - _LO).add_(_LO)).clamp_(-2.0, 2.0)
    return x.to(dtype)


def dense_init(gen, shape, in_axis_size, dtype) -> torch.Tensor:
    u = truncated_normal(gen, shape, torch.float32)
    return u.mul_(1.0 / math.sqrt(in_axis_size)).to(dtype)


def embed_init(gen, shape, dtype) -> torch.Tensor:
    return truncated_normal(gen, shape, torch.float32).mul_(0.02).to(dtype)


# ---------------------------------------------------------------- norms


def _rms_norm_impl(x, scale, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_impl(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        r = torch.rsqrt(var + ctx.eps)
        xhat = x32 * r
        gs = g32 * (1.0 + scale.float())
        dx = r * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        dscale = (g32 * xhat).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float):
    """RMSNorm with the (1 + scale) convention (scale stored as
    "scale - 1", so zeros are the identity), in f32, cast back. Saves
    x and scale only."""
    return _RMSNorm.apply(x, scale, eps)


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


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.gelu(x, approximate="none")

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x32 = x.float()
        cdf = 0.5 * (1.0 + torch.erf(x32 / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * x32 * x32) / math.sqrt(2.0 * math.pi)
        return (g.float() * (cdf + x32 * pdf)).to(x.dtype)


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.silu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x32 = x.float()
        s = torch.sigmoid(x32)
        return (g.float() * s * (1.0 + x32 * (1.0 - s))).to(x.dtype)


_K_TANH = math.sqrt(2.0 / math.pi)
_C_TANH = 0.044715


class _GeluTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.gelu(x, approximate="tanh")

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x32 = x.float()
        t = torch.tanh(_K_TANH * (x32 + _C_TANH * x32 * x32 * x32))
        dt = _K_TANH * (1.0 + 3.0 * _C_TANH * x32 * x32)
        d = 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * dt
        return (g.float() * d).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU; saves its input only."""
    return _Gelu.apply(x)


def gelu_tanh(x):
    """tanh-approximate GELU, `jax.nn.gelu`'s default form (the RG-LRU
    branch gate uses it; the MLPs use the exact one); saves its input
    only."""
    return _GeluTanh.apply(x)


def silu(x):
    """x * sigmoid(x); saves its input only."""
    return _Silu.apply(x)


_ACTIVATIONS = {"gelu": gelu, "silu": silu, "relu": F.relu}


def activation(name: str):
    """The activation of a config's `act` (the JAX package's
    `layers.activation`): exact GELU and SiLU as the Functions above,
    which save only their input."""
    return _ACTIVATIONS[name]


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x32, w):
        ctx.save_for_backward(x32, w)
        return x32 @ w.float()

    @staticmethod
    def backward(ctx, g):
        x32, w = ctx.saved_tensors
        dx = g @ w.float().t()
        dw = x32.reshape(-1, x32.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw.to(w.dtype)


def matmul_f32(x32, w):
    """x32 @ w.astype(f32) for an f32 x32 and a (K, N) weight of any
    float dtype. Saves x32 and the weight itself, never its f32 copy
    (which would be a fresh storage the training engine could not tell
    from an activation); backward recasts the weight."""
    return _MatmulF32.apply(x32, w)


# ---------------------------------------------------------------- MLP


def init_mlp(gen, d_model, d_ff, dtype, lead=(), glu: bool = False
             ) -> Params:
    lead = tuple(lead)
    p = {
        "w_in": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w_out": dense_init(gen, lead + (d_ff, d_model), d_ff, dtype),
    }
    if glu:
        p["w_gate"] = dense_init(gen, lead + (d_model, d_ff), d_model, dtype)
    return p


def apply_mlp(p: Params, x, act: str = "gelu", glu: bool = False):
    """act(x @ w_gate) * (x @ w_in) @ w_out when gated, else the classic
    2-layer act(x @ w_in) @ w_out of the paper's GPT."""
    f = activation(act)
    h = x @ p["w_in"]
    h = f(x @ p["w_gate"]) * h if glu else f(h)
    # the memory tiers' "mlp_hidden" (`models/marks.py`)
    h = checkpoint_name(h, "mlp_hidden")
    return h @ p["w_out"]


# ---------------------------------------------------------------- conv1d
# (causal, depthwise)


def init_conv1d(gen, width, channels, dtype, lead=()) -> Params:
    lead = tuple(lead)
    return {"w": dense_init(gen, lead + (width, channels), width, dtype),
            "b": torch.zeros(lead + (channels,), dtype=dtype,
                             device=gen.device)}


def _conv1d_fwd(x, w, b):
    """sum_i xp[:, i:i+S] * w[i] + b over the zero-left-padded input, in
    the JAX package's order (taps summed from i = 0)."""
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, 0:S] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + S] * w[i]
    return y + b


class _Conv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _conv1d_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        width, S = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, width - 1, 0))
        # y[t] = sum_i xp[t + i] w[i], xp[t'] = x[t' - (W-1)]:
        # dx[s] = sum_i g[s + W-1 - i] w[i], dw[i] = sum_t xp[t+i] g[t]
        gp = F.pad(g, (0, 0, 0, width - 1))
        dx = gp[:, width - 1:width - 1 + S] * w[0]
        for i in range(1, width):
            dx = dx + gp[:, width - 1 - i:width - 1 - i + S] * w[i]
        lead = tuple(range(g.dim() - 1))
        dw = torch.stack([(xp[:, i:i + S] * g).sum(dim=lead)
                          for i in range(width)])
        return dx, dw, g.sum(dim=lead)


def apply_conv1d(p: Params, x, state=None):
    """Depthwise causal conv over x: (B, S, C). Returns (y, new_state):
    new_state is the last W-1 inputs, the cache a streaming decode starts
    from. With state=None (training and prefill) x is zero-left-padded
    and only x and w are saved; a (B, W-1, C) `state` (streaming decode)
    left-pads x with the cached inputs instead, in the JAX package's tap
    order."""
    width = p["w"].shape[0]
    if state is None:
        y = _Conv1d.apply(x, p["w"], p["b"])
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        S = x.shape[1]
        y = xp[:, 0:S] * p["w"][0]
        for i in range(1, width):
            y = y + xp[:, i:i + S] * p["w"][i]
        y = y + p["b"]
    return y, (xp[:, xp.shape[1] - (width - 1):] if width > 1 else None)
