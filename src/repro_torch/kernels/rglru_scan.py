"""RG-LRU scan: the wrapper around the hand-written Hopper kernel
`csrc/rglru_scan_fwd.cu`, beside its plain PyTorch versions
`rglru_sequential` and `rglru_chunked`.

The kernel replaces the TPU kernel
`src/repro/kernels/rglru_scan.py::_rglru_kernel` (Pallas,
`rglru_scan_fwd`): h_t = exp(log_a_t) h_{t-1} + x_t over (B, S, W), in
f32. The source's header says what bounds it and what its design does:
three chunk-parallel passes (`KERNELS_PER_CALL`: chunk summaries, the
carries across chunks, the rescan) over f32 scratch allocated here;
`rglru_plan` mirrors their grids and the scratch for the CPU tests, and
the card checks hold it against `library_plan`, the built library's own
numbers. `rglru_chunked` is those passes in plain PyTorch, for the tests.

`rglru_scan` is a `torch.autograd.Function` standing where the JAX
package's `kernels/ops.py::rglru_scan` (`custom_vjp`) stands. The JAX
backward is the VJP of the sequential oracle; that VJP is itself a
reverse recurrence,

    gx_t = g_t + exp(log_a_{t+1}) gx_{t+1},  dx = gx,
    dlog_a_t = gx_t exp(log_a_t) h_{t-1},

so backward runs the kernel's reverse mode with dlog_a fused into its
rescan (`rglru_scan_bwd`). Forward saves log_a and the output h (not x:
h is saved anyway by the gate product that follows, and the training
engine stores one storage once). CPU tensors take the plain version
both ways; CUDA tensors launch the kernel or raise.
`rglru_scan.launches` counts calls of the kernel path (one per forward,
one per backward, each launching `KERNELS_PER_CALL` CUDA kernels) and
nothing else. `work` is the one count of a call's work, which each call
reports to the active op counter (`launch/op_stats.py`), on the card and
on the meta device alike, and `chip_smoke.py` prices.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.launch.op_stats import KernelWork, report_kernel

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc constants: steps per chunk, columns per block
CHUNK, THREADS = 64, 128
PASSES = ("summary", "carry", "rescan")
KERNELS_PER_CALL = len(PASSES)
MAX_GRID_YZ = 65535


def work(x, tensors: int = 3) -> KernelWork:
    """One call's work: `tensors` f32 tensors of x's size read or written
    once (3 forward: log_a, x, h; 5 in the backward: log_a, g, h, dx,
    dlog_a), and one exp and one FMA per element in f32 (the memory side
    bounds it by far)."""
    return KernelWork("rglru_scan", float(2 * x.numel()),
                      float(tensors * x.numel() * 4), "float32")


# ------------------------------------------------------------ plain versions

def rglru_sequential(log_a, x, *, reverse: bool = False):
    """The kernel's recurrence step by step in plain PyTorch, f32 (f64
    for f64 inputs: the exact recurrence the card checks hold slow decays
    to).

    Forward:  h_t = exp(log_a_t) h_{t-1} + x_t for t = 0..S-1, h_{-1} = 0.
    Reverse:  h_t = exp(log_a_{t+1}) h_{t+1} + x_t for t = S-1..0,
              h_S = 0 (the backward's recurrence, fed the output grad).
    log_a, x: (B, S, W). Returns h: (B, S, W) f32 (or f64)."""
    dtype = torch.promote_types(torch.promote_types(log_a.dtype, x.dtype),
                                torch.float32)
    la, xs = log_a.to(dtype), x.to(dtype)
    S = xs.shape[1]
    h = torch.zeros((xs.shape[0],) + xs.shape[2:], dtype=dtype,
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


def _dlog_a(log_a, gx, h):
    """dlog_a_t = (gx_t exp(log_a_t)) h_{t-1}, h_{-1} = 0."""
    h_prev = F.pad(h.float()[:, :-1], (0, 0, 1, 0))
    return gx * torch.exp(log_a.float()) * h_prev


def rglru_chunked(log_a, x, *, chunk: int = CHUNK, reverse: bool = False,
                  h=None):
    """The kernel's three passes in plain PyTorch, f32: chunks of `chunk`
    steps from the start (the last one ragged); (1) each chunk run from 0
    to its end value e_k, its log decays summed in step order into
    A_k = exp(sum); (2) the carries c_0 = 0, c_{k+1} = A_k c_k + e_k;
    (3) each chunk run again from c_k. Reverse mode walks the chunks and
    their steps from the end with the decay log_a_{t+1} (0 at t = S-1).
    Given the forward's output `h` (reverse only) it returns (gx, dlog_a)
    with dlog_a_t = (gx_t exp(log_a_t)) h_{t-1}, as the fused backward
    writes it; else h (B, S, W)."""
    if h is not None and not reverse:
        raise ValueError("the fused dlog_a is the reverse mode's")
    la, xs = log_a.float(), x.float()
    B, S, W = xs.shape
    nc = -(-S // chunk)
    pad = (0, 0, 0, nc * chunk - S)
    a = la
    if reverse:                 # step t decays by log_a_{t+1}
        a = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    # padded steps (a = x = 0) come after the end, or first in reverse,
    # where h stays 0
    a, v = F.pad(a, pad), F.pad(xs, pad)
    if reverse:
        a, v = a.flip(1), v.flip(1)
    a = a.reshape(B, nc, chunk, W)
    v = v.reshape(B, nc, chunk, W)
    dec = torch.exp(a)

    e = torch.zeros((B, nc, W), dtype=torch.float32, device=xs.device)
    logsum = torch.zeros_like(e)
    for i in range(chunk):                      # 1. chunk summaries
        logsum = logsum + a[:, :, i]
        e = dec[:, :, i] * e + v[:, :, i]
    A = torch.exp(logsum)
    c = torch.zeros((B, W), dtype=torch.float32, device=xs.device)
    carries = []
    for k in range(nc):                         # 2. carries
        carries.append(c)
        c = A[:, k] * c + e[:, k]
    acc = torch.stack(carries, dim=1)
    out = []
    for i in range(chunk):                      # 3. rescan
        acc = dec[:, :, i] * acc + v[:, :, i]
        out.append(acc)
    out = torch.stack(out, dim=2).reshape(B, nc * chunk, W)
    if reverse:
        out = out.flip(1)
    out = out[:, :S]
    return out if h is None else (out, _dlog_a(la, out, h))


def scan_scale(h, *, reverse: bool = False):
    """The largest |h_s| the scan has carried up to each step t (s <= t,
    or s >= t in reverse). A scan's rounding error at t is a fraction of
    this, not of |h_t|, which crosses zero where the error does not: where
    the decay is slow (log_a near 0) h grows to O(sqrt(S)) and an f32
    evaluation in any other order than the oracle's misses tol x (1 +
    |h_t|). The checks of slow decays hold the error to tol x (1 + this)."""
    a = h.float().abs()
    if reverse:
        a = a.flip(1)
    m = torch.cummax(a, dim=1).values
    return m.flip(1) if reverse else m


def dlog_a_scale(gx, h):
    """The carried scale of dlog_a_t = gx_t exp(log_a_t) h_{t-1}: each
    factor's error is a fraction of its own carried scale, so dlog_a's
    is of scan_scale(gx, reverse) |h_{t-1}| + |gx_t| scan_scale(h)_{t-1}
    (exp(log_a_t) <= 1)."""
    def prev(t):
        return F.pad(t[:, :-1], (0, 0, 1, 0))
    return (scan_scale(gx, reverse=True) * prev(h.float().abs())
            + gx.float().abs() * prev(scan_scale(h)))


# ------------------------------------------------------------ the kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan_fwd")
    fn = lib.repro_rglru_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 3 + [_LL] * 4 + [_I, _P]
        fn.restype = ctypes.c_int
        lib.repro_rglru_scan_bwd.argtypes = ([_P] * 8 + [_I] * 3
                                             + [_LL] * 6 + [_P])
        lib.repro_rglru_scan_bwd.restype = ctypes.c_int
        lib.repro_rglru_scan_plan.argtypes = [_I, _I, _I,
                                              ctypes.POINTER(_LL)]
        lib.repro_rglru_scan_plan.restype = ctypes.c_int
    return lib


def rglru_plan(B: int, S: int, W: int) -> dict:
    """The launch plan of one call (csrc `make_plan`): the chunk length
    and count, each pass's grid (x, y, z) and threads in launch order,
    and the float32 scratch, e, A and c of shape (B, chunks, W) each, and
    its bytes."""
    nc, gx = -(-S // CHUNK), -(-W // THREADS)
    return {
        "chunk": CHUNK,
        "chunks": nc,
        "passes": {
            "summary": dict(grid=(gx, nc, B), threads=THREADS),
            "carry": dict(grid=(gx, B, 1), threads=THREADS),
            "rescan": dict(grid=(gx, nc, B), threads=THREADS),
        },
        "scratch": (3, B, nc, W),
        "scratch_bytes": 3 * 4 * B * nc * W,
    }


def library_plan(B: int, S: int, W: int) -> dict:
    """`rglru_plan`, less the scratch shape, as the built library
    launches it."""
    out = (_LL * (3 + 4 * KERNELS_PER_CALL))()
    if _lib().repro_rglru_scan_plan(B, S, W, out):
        raise ValueError(f"the kernel refuses B={B} S={S} W={W}")
    return {"chunk": out[0], "chunks": out[1], "scratch_bytes": out[2],
            "passes": {name: dict(grid=tuple(out[3 + 4 * i:6 + 4 * i]),
                                  threads=out[6 + 4 * i])
                       for i, name in enumerate(PASSES)}}


def _check(*ts):
    if ts[0].dim() != 3 or any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"rglru_scan takes tensors of one shape (B, S, W), "
                         f"not {[tuple(t.shape) for t in ts]}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("rglru_scan inputs must be on one device")


def check_kernel_inputs(*ts) -> dict:
    """Raise ValueError on what the kernel does not take (metadata only,
    so it also runs on CPU tensors); else return the plan. ts: log_a and
    x, or log_a, the output gradient and h."""
    _check(*ts)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"the rglru_scan kernel takes float32, not "
                         f"{[t.dtype for t in ts]}")
    if any(t.stride(2) != 1 for t in ts):
        raise ValueError("the last dimension of every rglru_scan input "
                         "must be contiguous")
    B, S, W = ts[0].shape
    plan = rglru_plan(B, S, W)
    if B > MAX_GRID_YZ or plan["chunks"] > MAX_GRID_YZ:
        raise ValueError(f"batch {B} or {plan['chunks']} chunks of "
                         f"{CHUNK} steps > {MAX_GRID_YZ}")
    return plan


def _launch(entry, ts, outs, plan, *extra):
    """Allocate the scratch, report the call's work, run the library's
    `entry` on the current stream, count it (on the meta device: the
    scratch and the report only)."""
    dev = ts[0].device
    scratch = list(torch.empty(plan["scratch"], dtype=torch.float32,
                               device=dev))
    report_kernel(work(ts[0], len(ts) + len(outs)))
    if dev.type == "meta":
        return
    fn = getattr(_lib(), entry)
    B, S, W = ts[0].shape
    strides = [s for t in ts for s in (t.stride(0), t.stride(1))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in ts + outs + scratch), B, S, W,
                 *strides, *extra, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: cudaError_t {err}")
    rglru_scan.launches += 1


def _on_card(t):
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not "
                         f"{t.device.type}")


def rglru_scan_fwd(log_a, x, *, reverse: bool = False):
    """One pass of the recurrence (see `rglru_sequential`), no autograd.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. On the card: log_a and x float32 with a contiguous last
    dimension (batch and time strides are free), B and the chunk count
    at most 65535. The output and scratch are allocated here; the passes
    run on the current stream."""
    _check(log_a, x)
    if x.device.type == "cpu":
        return rglru_sequential(log_a, x, reverse=reverse)
    _on_card(x)
    plan = check_kernel_inputs(log_a, x)
    h = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("repro_rglru_scan_fwd", [log_a, x], [h], plan,
            int(reverse))
    return h


def rglru_scan_bwd(log_a, g, h):
    """(dlog_a, dx) of the forward h = rglru_scan(log_a, x) for the
    output gradient g: dx is the reverse recurrence over g, and dlog_a_t
    = (dx_t exp(log_a_t)) h_{t-1}. CPU tensors run the reverse
    `rglru_sequential` and that product; CUDA tensors launch the kernel
    (its reverse mode with dlog_a fused into the rescan) or raise, under
    `rglru_scan_fwd`'s conditions for all three inputs."""
    _check(log_a, g, h)
    if g.device.type == "cpu":
        gx = rglru_sequential(log_a, g, reverse=True)
        return _dlog_a(log_a, gx, h), gx
    _on_card(g)
    plan = check_kernel_inputs(log_a, g, h)
    gx, dla = (torch.empty(g.shape, dtype=torch.float32, device=g.device)
               for _ in range(2))
    _launch("repro_rglru_scan_bwd", [log_a, g, h], [gx, dla], plan)
    return dla, gx


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
        return rglru_scan_bwd(log_a, g, h)


def rglru_scan(log_a, x):
    """h (B,S,W) f32 of h_t = exp(log_a_t) h_{t-1} + x_t, differentiable:
    the kernel both ways (the plain version on CPU tensors)."""
    return _RGLRUScan.apply(log_a, x)


rglru_scan.launches = 0
