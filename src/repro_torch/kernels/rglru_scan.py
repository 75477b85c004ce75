"""RG-LRU scan: the wrapper around the hand-written Hopper kernel
`csrc/rglru_scan_fwd.cu`, beside its plain PyTorch version
`rglru_sequential`.

The kernel replaces the TPU kernel
`src/repro/kernels/rglru_scan.py::_rglru_kernel` (Pallas,
`rglru_scan_fwd`): h_t = exp(log_a_t) h_{t-1} + x_t over (B, S, W), in
f32, sequentially in time. The source's header says what bounds it and
what its design does.

`rglru_scan` is a `torch.autograd.Function` standing where the JAX
package's `kernels/ops.py::rglru_scan` (`custom_vjp`) stands. The JAX
backward is the VJP of the sequential oracle; that VJP is itself a
reverse recurrence,

    gx_t = g_t + exp(log_a_{t+1}) gx_{t+1},  dx = gx,
    dlog_a_t = gx_t exp(log_a_t) h_{t-1},

so backward runs the same kernel in its reverse mode. Forward saves
log_a and the output h (not x: h is saved anyway by the gate product
that follows, and the training engine stores one storage once). CPU
tensors take the plain version both ways; CUDA tensors launch the
kernel or raise. `rglru_scan.launches` counts kernel launches, forward
and backward, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ------------------------------------------------------------ plain version

def rglru_sequential(log_a, x, *, reverse: bool = False):
    """The kernel's recurrence step by step in plain PyTorch, f32.

    Forward:  h_t = exp(log_a_t) h_{t-1} + x_t for t = 0..S-1, h_{-1} = 0.
    Reverse:  h_t = exp(log_a_{t+1}) h_{t+1} + x_t for t = S-1..0,
              h_S = 0 (the backward's recurrence, fed the output grad).
    log_a, x: (B, S, W). Returns h: (B, S, W) f32."""
    la, xs = log_a.float(), x.float()
    S = xs.shape[1]
    h = torch.zeros((xs.shape[0],) + xs.shape[2:], dtype=torch.float32,
                    device=xs.device)
    hs = []
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        if not reverse:
            h = torch.exp(la[:, t]) * h + xs[:, t]
        elif t + 1 < S:
            h = torch.exp(la[:, t + 1]) * h + xs[:, t]
        else:
            h = xs[:, t]
        hs.append(h)
    if reverse:
        hs.reverse()
    return torch.stack(hs, dim=1)


# ------------------------------------------------------------ the kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan_fwd")
    fn = lib.repro_rglru_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def rglru_scan_fwd(log_a, x, *, reverse: bool = False):
    """One pass of the recurrence (see `rglru_sequential`), no autograd.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. On the card: log_a and x float32 with a contiguous last
    dimension (batch and time strides are free), B <= 65535. The output
    is allocated here; the kernel runs on the current stream."""
    if log_a.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"rglru_scan takes log_a and x of one shape "
                         f"(B, S, W), not {tuple(log_a.shape)} and "
                         f"{tuple(x.shape)}")
    if log_a.device != x.device:
        raise ValueError("rglru_scan inputs must be on one device")
    if x.device.type == "cpu":
        return rglru_sequential(log_a, x, reverse=reverse)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    B, S, W = x.shape
    if log_a.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"log_a and x must be float32, not "
                         f"{log_a.dtype}/{x.dtype}")
    if log_a.stride(2) != 1 or x.stride(2) != 1:
        raise ValueError("the last dimension of log_a and x must be "
                         "contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} > 65535")
    h = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_rglru_scan_fwd(
            log_a.data_ptr(), x.data_ptr(), h.data_ptr(), B, S, W,
            log_a.stride(0), log_a.stride(1), x.stride(0), x.stride(1),
            int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: cudaError_t "
                           f"{err}")
    rglru_scan.launches += 1
    return h


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, x):
        h = rglru_scan_fwd(log_a, x)
        ctx.save_for_backward(log_a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        log_a, h = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        gx = rglru_scan_fwd(log_a, g, reverse=True)
        h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))
        return gx * torch.exp(log_a.float()) * h_prev, gx


def rglru_scan(log_a, x):
    """h (B,S,W) f32 of h_t = exp(log_a_t) h_{t-1} + x_t, differentiable:
    the kernel both ways (the plain version on CPU tensors)."""
    return _RGLRUScan.apply(log_a, x)


rglru_scan.launches = 0
