"""Mamba-2 (SSD, state-space duality) mixer block of the port, mirroring
the JAX package's `repro/models/mamba2.py`. [arXiv:2405.21060]

`apply_mamba2(impl="torch")` runs the plain chunked scan
(`kernels/ssd_scan.py::ssd_chunked`) under autograd; `impl="cuda"` runs
`kernels.ssd_scan.ssd_scan`, the hand-written CUDA kernel with the plain
chunked VJP (on CPU tensors its plain version): the port's counterpart of
the JAX package's `impl="pallas"`. `decode_mamba2` is the one-token
decode step of serving: the conv window and the f32 (H, P, N) state
advance by one token, written into the cache IN PLACE.

Under a tensor axis (`tp`, `parallel/comm.py::TpGroup`) `apply_mamba2`
runs this rank's heads on the layout of `parallel/sharding.py::
layout_specs`: its z and x columns of `w_zx`, its x channels of the conv
weight beside the whole B | C channels, its columns of `w_dt` and
`norm_scale`, its rows of `w_out` (the caller sums the output over the
axis). B and C, which every head reads, are computed whole on every
rank from `w_bc` and the conv's B | C channels, and `dt_bias`, `A_log`,
`D_skip` and the conv bias are whole, each rank reading its heads'
slice: each of these takes `grad_sum`, so its gradient is the sum over
the axis. The gated norm's variance over the whole inner width sums its
squares over the axis in both directions (`TpGroup.sum`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.models.layers import (apply_conv1d, dense_init,
                                       init_conv1d, silu)

__all__ = ["SSMDims", "ssm_dims", "init_mamba2", "apply_mamba2",
           "decode_mamba2", "ssd_chunked", "tp_heads"]


class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv_channels: int


def ssm_dims(cfg: ModelConfig) -> SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_channels = d_inner + 2 * cfg.ssm_state_dim  # x, B, C convolved
    return SSMDims(d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                   conv_channels)


def init_mamba2(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    """The JAX package's leaves and distributions; dt_bias, A_log and
    D_skip are float32 whatever the model dtype."""
    dims = ssm_dims(cfg)
    lead = tuple(lead)
    D, dev = cfg.d_model, gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_zx": dense_init(gen, lead + (D, 2 * dims.d_inner), D, dtype),
        "w_bc": dense_init(gen, lead + (D, 2 * dims.state), D, dtype),
        "w_dt": dense_init(gen, lead + (D, dims.n_heads), D, dtype),
        "dt_bias": torch.zeros(lead + (dims.n_heads,), **f32),
        "conv": init_conv1d(gen, cfg.ssm_conv_width, dims.conv_channels,
                            dtype, lead),
        "A_log": torch.zeros(lead + (dims.n_heads,), **f32),
        "D_skip": torch.ones(lead + (dims.n_heads,), **f32),
        "norm_scale": torch.zeros(lead + (dims.d_inner,), dtype=dtype,
                                  device=dev),
        "w_out": dense_init(gen, lead + (dims.d_inner, D), dims.d_inner,
                            dtype),
    }


def tp_heads(dims: SSMDims, tp_size: int) -> int:
    """The SSM heads a rank of a tensor axis of `tp_size` runs; a
    ValueError when the axis does not divide them."""
    if dims.n_heads % tp_size:
        raise ValueError(f"a tensor axis of {tp_size} ranks does not divide "
                         f"the {dims.n_heads} SSM heads of {dims.head_dim} "
                         f"(d_inner {dims.d_inner})")
    return dims.n_heads // tp_size


def _gated_norm(y, z, scale, eps, tp=None):
    """rms_norm(y * silu(z)) over the inner width; `y`, `z` and `scale`
    this rank's share of it under a tensor axis `tp`."""
    y32 = y.float() * silu(z.float())
    if tp is None:
        var = y32.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.sum(y32.square().sum(dim=-1, keepdim=True)) / (
            y32.shape[-1] * tp.size)
    return y32 * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _split_proj(p, x, dims: SSMDims):
    zx = x @ p["w_zx"]
    z, xs = zx.chunk(2, dim=-1)
    bc = x @ p["w_bc"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    return z, xs, bc, dt


def _rank_share(p, dims: SSMDims, tp):
    """(p, its conv, dims) of this rank's heads on a tensor axis `tp`
    (the module doc): `dt_bias`, `A_log` and `D_skip` sliced to them,
    the conv weight's x channels of these heads beside the whole B | C
    channels (and the bias cut alike), `d_inner` the rank's share; each
    replicated value read after `grad_sum`."""
    n_heads = tp_heads(dims, tp.size)
    h0, inner = tp.rank * n_heads, n_heads * dims.head_dim
    w_bc, conv_w, conv_b, dt_bias, A_log, D_skip = tp.grad_sum(
        p["w_bc"], p["conv"]["w"], p["conv"]["b"], p["dt_bias"],
        p["A_log"], p["D_skip"])
    heads = slice(h0, h0 + n_heads)
    p = dict(p, w_bc=w_bc, dt_bias=dt_bias[heads], A_log=A_log[heads],
             D_skip=D_skip[heads])
    # the local conv weight is [x channels of these heads | B | C]: its
    # x part is this rank's own, its B | C part (and the whole bias)
    # replicated
    conv = {"w": torch.cat([p["conv"]["w"][:, :inner], conv_w[:, inner:]],
                           dim=1),
            "b": torch.cat([conv_b[h0 * dims.head_dim:
                                   h0 * dims.head_dim + inner],
                            conv_b[dims.d_inner:]])}
    return p, conv, dims._replace(d_inner=inner, n_heads=n_heads)


def apply_mamba2(p, x, cfg: ModelConfig, *, impl: str = "torch", tp=None):
    """Training / prefill. x: (B, S, D) -> (y, final_cache). Under a
    tensor axis `tp` x is the parallel region's input (`TpGroup.enter`)
    and y this rank's partial sum of the output (see the module doc)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown ssm impl {impl!r} (torch | cuda)")
    dims = ssm_dims(cfg)
    B, S, _ = x.shape
    conv = p["conv"]
    if tp is not None:
        p, conv, dims = _rank_share(p, dims, tp)
    n_heads = dims.n_heads
    z, xs, bc, dt = _split_proj(p, x, dims)
    conv_out, conv_state = apply_conv1d(conv, torch.cat([xs, bc], dim=-1))
    conv_out = silu(conv_out.float()).to(x.dtype)
    xs = conv_out[..., :dims.d_inner]
    B_s = conv_out[..., dims.d_inner:dims.d_inner + dims.state]
    C_s = conv_out[..., dims.d_inner + dims.state:]

    A = -torch.exp(p["A_log"])                         # (H,) negative
    dA_log = dt * A                                    # (B,S,H)
    xh32 = xs.reshape(B, S, n_heads, dims.head_dim).float()
    xh_dt = xh32 * dt[..., None]

    if impl == "cuda":
        y, final_state = ssd_scan(xh_dt, dA_log, B_s, C_s,
                                  chunk=cfg.ssm_chunk)
    else:
        y, final_state = ssd_chunked(xh_dt, dA_log, B_s, C_s, cfg.ssm_chunk)
    y = y + xh32 * p["D_skip"][:, None]
    y = y.reshape(B, S, dims.d_inner)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps, tp).to(x.dtype)
    out = y @ p["w_out"]
    return out, {"conv": conv_state, "state": final_state}


def decode_mamba2(p, x1, cache, cfg: ModelConfig, *, tp=None):
    """One-token decode. x1: (B, 1, D); cache {"conv": (B, W-1, C),
    "state": (B, H, P, N) f32}, both advanced IN PLACE. The state update
    and y = C.state + D_skip.x run in f32, as the JAX package's do. Under
    a tensor axis `tp` the cache holds this rank's heads (its conv window
    x of those heads beside B | C whole) and the output is its partial
    sum, as `apply_mamba2`'s."""
    dims = ssm_dims(cfg)
    B = x1.shape[0]
    conv = p["conv"]
    if tp is not None:
        p, conv, dims = _rank_share(p, dims, tp)
    z, xs, bc, dt = _split_proj(p, x1, dims)
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out, conv_state = apply_conv1d(conv, conv_in, cache["conv"])
    conv_out = silu(conv_out.float()).to(x1.dtype)
    xs = conv_out[..., :dims.d_inner]
    B_s = conv_out[..., dims.d_inner:dims.d_inner + dims.state]
    C_s = conv_out[..., dims.d_inner + dims.state:]

    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0] * A)                       # (B,H)
    xh = xs.reshape(B, dims.n_heads, dims.head_dim).float()
    xh_dt = xh * dt[:, 0, :, None]
    state = (cache["state"] * dA[:, :, None, None]
             + torch.einsum("bn,bhp->bhpn", B_s[:, 0].float(), xh_dt))
    y = torch.einsum("bn,bhpn->bhp", C_s[:, 0].float(), state)
    y = y + xh * p["D_skip"][:, None]
    y = y.reshape(B, 1, dims.d_inner)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps, tp).to(x1.dtype)
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(state)
    return y @ p["w_out"]
