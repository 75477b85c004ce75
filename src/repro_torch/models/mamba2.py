"""Mamba-2 (SSD, state-space duality) mixer block of the port, mirroring
the JAX package's `repro/models/mamba2.py` (training / prefill path).
[arXiv:2405.21060]

`apply_mamba2(impl="torch")` runs the plain chunked scan
(`kernels/ssd_scan.py::ssd_chunked`) under autograd; `impl="cuda"` runs
`kernels.ssd_scan.ssd_scan`, the hand-written CUDA kernel with the plain
chunked VJP (on CPU tensors its plain version): the port's counterpart of
the JAX package's `impl="pallas"`. The one-token decode
(`decode_mamba2`) belongs to serving mamba2 and is not ported yet.
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
           "ssd_chunked"]


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


def _gated_norm(y, z, scale, eps):
    y32 = y.float() * silu(z.float())
    var = y32.square().mean(dim=-1, keepdim=True)
    return y32 * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _split_proj(p, x, dims: SSMDims):
    zx = x @ p["w_zx"]
    z, xs = zx.chunk(2, dim=-1)
    bc = x @ p["w_bc"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    return z, xs, bc, dt


def apply_mamba2(p, x, cfg: ModelConfig, *, impl: str = "torch"):
    """Training / prefill. x: (B, S, D) -> (y, final_cache)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown ssm impl {impl!r} (torch | cuda)")
    dims = ssm_dims(cfg)
    B, S, _ = x.shape
    z, xs, bc, dt = _split_proj(p, x, dims)
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out, conv_state = apply_conv1d(p["conv"], conv_in)
    conv_out = silu(conv_out.float()).to(x.dtype)
    xs = conv_out[..., :dims.d_inner]
    B_s = conv_out[..., dims.d_inner:dims.d_inner + dims.state]
    C_s = conv_out[..., dims.d_inner + dims.state:]

    A = -torch.exp(p["A_log"])                         # (H,) negative
    dA_log = dt * A                                    # (B,S,H)
    xh32 = xs.reshape(B, S, dims.n_heads, dims.head_dim).float()
    xh_dt = xh32 * dt[..., None]

    if impl == "cuda":
        y, final_state = ssd_scan(xh_dt, dA_log, B_s, C_s,
                                  chunk=cfg.ssm_chunk)
    else:
        y, final_state = ssd_chunked(xh_dt, dA_log, B_s, C_s, cfg.ssm_chunk)
    y = y + xh32 * p["D_skip"][:, None]
    y = y.reshape(B, S, dims.d_inner)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(x.dtype)
    out = y @ p["w_out"]
    return out, {"conv": conv_state, "state": final_state}
