"""Flash-attention forward: the wrapper around the hand-written Hopper
kernel `csrc/flash_attention_fwd.cu`.

The kernel replaces the TPU kernel
`src/repro/kernels/flash_attention.py::_attn_kernel` (Pallas,
`flash_attention_fwd`): GQA online-softmax attention with causal,
sliding-window and tanh-softcap options, m/l/acc carried in f32. bf16
inputs run on the bf16 tensor cores (`mma.sync`, FlashAttention-2
style); f32 inputs keep an f32-FMA kernel. The source's header note says
what bounds it and what each design does. `flash_plan`, `kv_tiles` and
`warp_live` mirror the kernel's launch arithmetic for the CPU tests; the
`library_*` functions ask the built library for the same numbers, and
the card checks hold the mirrors against them.

A CPU tensor goes to the plain reference (`kernels/ref.py`); a CUDA
tensor launches the kernel or raises. On the card the launch sits in a
`torch.autograd.Function` mirroring the JAX package's
`kernels/ops.py::flash_attention` (`custom_vjp`): forward saves only q, k
and v, and backward, `flash_attention_vjp`, is the VJP of
`attention_reference` recomputed under `enable_grad` (the JAX package has no backward kernel either; the FA-2
dq and dk/dv kernel pair is later speed work). `flash_attention.launches`
counts kernel launches (and nothing else), so a run can show that its
path went through the kernel. `work` is the one count of a call's work
(the unmasked pairs' products, each input read and the output written
once): each call reports it to the active op counter
(`launch/op_stats.py`), on the card and on the meta device alike, and
`chip_smoke.py` prices its bounds with it.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_reference
from repro_torch.launch.op_stats import KernelWork, report_kernel

HEAD_DIMS = (32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FMA_BQ, FMA_BK = 128, 32      # f32 kernel: query rows / keys per tile
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.repro_flash_attention_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                       _I, _I, _F, _F, _P]
        fn.restype = ctypes.c_int
    return lib


def flash_plan(D: int, dtype=torch.bfloat16) -> dict:
    """The kernel's tiling for head dim D (csrc `Mma<D>` for bf16, the
    `fma_*` constants for f32): query rows per block `bq`, keys per kv
    tile `bk`, threads, and dynamic shared memory in bytes."""
    if dtype == torch.float32:
        split = 2 if D > 128 else 1
        return dict(bq=FMA_BQ, bk=FMA_BK, threads=FMA_BQ * split,
                    smem=4 * (FMA_BQ * (D + 4 * split) + 2 * FMA_BK * D))
    bq = 128 if D <= 64 else 64
    bk = 64 if D <= 128 else 32
    # Q tile, then 2 stages of (K, V) tiles; rows of D + 8 bf16
    return dict(bq=bq, bk=bk, threads=bq // 16 * 32,
                smem=2 * (D + 8) * (bq + 4 * bk))


def kv_tiles(q0, bq, bk, Sq, Skv, causal, window):
    """The kv tiles the block of query rows [q0, q0 + bq) loads (the
    kernel's t_begin .. t_end)."""
    q_last = min(q0 + bq, Sq) - 1
    kv_end = min(Skv, q_last + 1) if causal else Skv
    kv_begin = max(0, q0 - window + 1) if window > 0 else 0
    return range(kv_begin // bk, (kv_end + bk - 1) // bk)


def warp_live(k0, r_lo, bk, Sq, causal, window) -> bool:
    """Whether the warp owning rows [r_lo, r_lo + 16) runs the products of
    the kv tile starting at key k0 (bf16 kernel)."""
    return (r_lo < Sq and not (causal and k0 > r_lo + 15)
            and not (window > 0 and k0 + bk - 1 <= r_lo - window))


def unmasked_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(row, col) score pairs the masks keep: the work this input needs
    (causal rows see keys up to their own index, a window the last
    `window` of them)."""
    r = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, r + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, r - window + 1) if window else 0
    return int(np.maximum(0, hi - lo).sum())


def work(q, k, v, *, causal: bool, window: int = 0) -> KernelWork:
    """One call's work: the score and value products of the unmasked
    pairs (4 B Hq D FLOPs a pair) in q's dtype, q, k and v read once and
    the output (q's size) written once."""
    B, Sq, Hq, D = q.shape
    nbytes = (2 * q.numel() * q.element_size()
              + k.numel() * k.element_size() + v.numel() * v.element_size())
    flops = 4 * B * Hq * D * unmasked_pairs(Sq, k.shape[1], causal, window)
    return KernelWork("flash_attention", float(flops), float(nbytes),
                      str(q.dtype).split(".")[-1])


def library_plan(D: int, dtype=torch.bfloat16) -> dict:
    """`flash_plan`'s numbers as the built library launches them."""
    out = (ctypes.c_longlong * 4)()
    if _lib().repro_flash_attention_plan(_DTYPES[dtype], D, out):
        raise ValueError(f"no kernel instance for D={D} {dtype}")
    return dict(bq=out[0], bk=out[1], threads=out[2], smem=out[3])


def library_kv_tiles(D, dtype, q0, Sq, Skv, causal, window) -> range:
    """`kv_tiles` of the (D, dtype) instance, computed by the library."""
    out = (ctypes.c_int * 2)()
    if _lib().repro_flash_attention_tiles(_DTYPES[dtype], D, q0, Sq, Skv,
                                          int(causal), window, out):
        raise ValueError(f"no kernel instance for D={D} {dtype}")
    return range(out[0], out[1])


def library_warp_live(D, k0, r_lo, Sq, causal, window) -> bool:
    """`warp_live` of the bf16 instance for D, computed by the library."""
    live = _lib().repro_flash_attention_warp_live(D, k0, r_lo, Sq,
                                                  int(causal), window)
    if live < 0:
        raise ValueError(f"no bf16 kernel instance for D={D}")
    return bool(live)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in
    q's dtype. Hq % Hkv == 0; query head h reads kv head h // (Hq/Hkv).

    On the card: D in HEAD_DIMS, dtype float32 or bfloat16 (one
    for all three), last dimension contiguous (other strides are free; for
    bfloat16 each pointer and stride a multiple of 16 bytes). The output
    is allocated here and the kernel runs on the current stream without
    synchronising. Differentiable either way."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device.type}")
    # meta tensors (shape-only counting, core/endurance.py) take the
    # kernel path's autograd Function and launch nothing
    return _FlashAttention.apply(q, k, v, causal, window, logit_cap)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap)
        return _launch(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_vjp(ctx.saved_tensors, g, **ctx.opts),
                None, None, None)


def flash_attention_vjp(qkv, g, *, causal, window, logit_cap):
    """The kernel's backward: (dq, dk, dv) of `flash_attention` at
    qkv = (q, k, v) against the output's gradient `g`, the VJP of
    `attention_reference` recomputed under `enable_grad`. The one
    backward of every node whose output is the kernel's: the kernel's
    own autograd Function and a held "attn_out"
    (`models/attention.py::attend_marked`)."""
    xs = [t.detach().requires_grad_(True) for t in qkv]
    with torch.enable_grad():
        o = attention_reference(*xs, causal=causal, window=window,
                                logit_cap=logit_cap)
        return torch.autograd.grad(o, xs, g)


def _aligned16(t) -> bool:
    """data_ptr and the (B, S, H) strides of dimensions longer than 1 are
    multiples of 16 bytes (the last dimension is contiguous)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * es) % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def check_kernel_inputs(q, k, v) -> None:
    """Raise ValueError on what the kernel does not take (metadata only,
    so it also runs on CPU tensors)."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         "kernel takes float32 or bfloat16, one for all")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last dimension of q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and not all(map(_aligned16, (q, k, v))):
        raise ValueError("bfloat16 q, k, v need 16-byte aligned pointers "
                         "and strides (the kernel copies 16-byte rows)")
    if min(B, Sq, Skv) < 1 or B * Hq > 65535:
        raise ValueError(f"unsupported sizes B={B} Sq={Sq} Skv={Skv} "
                         f"Hq={Hq}")


def _launch(q, k, v, *, causal, window, logit_cap):
    """The kernel on CUDA tensors; raises on what it does not take."""
    check_kernel_inputs(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    report_kernel(work(q, k, v, causal=causal, window=window))
    if q.device.type == "meta":
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, Hq, Hkv, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), float(logit_cap or 0.0),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
