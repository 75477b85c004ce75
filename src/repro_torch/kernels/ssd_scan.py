"""Mamba-2 SSD chunked scan: the wrapper around the hand-written Hopper
kernel `csrc/ssd_scan_fwd.cu`, beside its plain PyTorch version
`ssd_chunked`.

The kernel replaces the TPU kernel
`src/repro/kernels/ssd_scan.py::_ssd_kernel` (Pallas, `ssd_scan_fwd`):
per chunk of Q steps, with la = cumsum(dA_log) inside the chunk,

    y     = (C B^T o exp(la_i - la_j) [i >= j]) x + exp(la) (C state^T)
    state = exp(la_Q) state + (exp(la_Q - la) x)^T B

carrying an f32 (P, N) state from chunk to chunk; the chunk is halved
until it divides S. The source's header says what bounds it and what
its design does.

`ssd_scan` is a `torch.autograd.Function` mirroring the JAX package's
`kernels/ops.py::ssd_scan`: forward runs the kernel (a CPU tensor runs
the plain version), saves only (xh, dA_log, B_s, C_s), and backward is
the VJP of the plain chunked version recomputed under `enable_grad`.
(The JAX package differentiates the sequential `ssd_reference`; the
chunked form is the same function without a per-step saved state.)
`ssd_scan.launches` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MAX_CHUNK = 128               # rows of the kernel's per-thread G tiling
PB = 16                       # head-dim columns per block (csrc PB)
SMEM_LIMIT = 232448           # bytes of shared memory a Hopper block may use


def pick_chunk(S: int, chunk: int) -> int:
    """The chunk actually used: min(chunk, S), halved until it divides S
    (the Pallas wrapper's rule)."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


# ------------------------------------------------------------ plain version

def ssd_chunked(xh, dA_log, B_s, C_s, chunk: int, state0=None):
    """Chunked SSD scan in plain PyTorch (f32), a copy of the JAX package's
    `models/mamba2.py::ssd_chunked` with one change: the intra-chunk decay
    exp(La_i - La_j) is masked in the exponent (-inf above the diagonal)
    instead of after the exp. Above the diagonal La_i - La_j >= 0, which
    overflows to inf at full width over a 128-step chunk; the JAX form's
    `where(mask, exp(dd), 0)` survives the forward but its gradient is
    0 * inf = NaN. The forward values are the same.

    xh (B,S,H,P) inputs scaled by dt; dA_log (B,S,H); B_s, C_s (B,S,N).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    B, S, H, Pd = xh.shape
    N = B_s.shape[-1]
    chunk = pick_chunk(S, chunk)
    nc = S // chunk
    xc = xh.reshape(B, nc, chunk, H, Pd).float()
    ac = dA_log.reshape(B, nc, chunk, H).float()
    bc = B_s.reshape(B, nc, chunk, N).float()
    cc = C_s.reshape(B, nc, chunk, N).float()

    La = torch.cumsum(ac, dim=2)                        # (B,nc,Q,H)
    # --- intra-chunk (quadratic) term ---
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)         # (B,nc,Q,Q)
    dd = La[:, :, :, None, :] - La[:, :, None, :, :]    # (B,nc,Q,Q,H)
    iq = torch.arange(chunk, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    m = torch.exp(torch.where(causal, dd, float("-inf")))
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", g, m, xc)

    # --- chunk states ---
    decay_to_end = torch.exp(La[:, :, -1:, :] - La)     # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end, bc, xc)

    # --- inter-chunk recurrence over the chunks ---
    chunk_decay = torch.exp(La[:, :, -1, :])            # (B,nc,H)
    state = (torch.zeros((B, H, Pd, N), dtype=torch.float32,
                         device=xh.device)
             if state0 is None else state0.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    states_in = torch.stack(states_in, dim=1)           # (B,nc,H,P,N)

    # --- inter-chunk output term ---
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(La), cc,
                           states_in)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return y, state


# ------------------------------------------------------------ the kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan_fwd")
    fn = lib.repro_ssd_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _LL, _LL, _LL, _LL, _P]
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(Q: int, N: int) -> int:
    """Dynamic shared memory of one block (csrc layout: B and C tiles and
    the state slice with rows padded to N+1, the masked G tile with rows
    padded to Q+1, the x slice, la and the decay-to-end vector)."""
    return 4 * (2 * Q * (N + 1) + Q * (Q + 1) + Q * PB + PB * (N + 1)
                + 2 * Q)


def _check(xh, dA_log, B_s, C_s):
    if xh.dim() != 4 or dA_log.dim() != 3 or B_s.dim() != 3 \
            or C_s.dim() != 3:
        raise ValueError("ssd_scan takes xh (B,S,H,P), dA_log (B,S,H), "
                         "B_s and C_s (B,S,N)")
    B, S, H, _ = xh.shape
    if dA_log.shape != (B, S, H) or B_s.shape != C_s.shape \
            or B_s.shape[:2] != (B, S):
        raise ValueError(f"shape mismatch: xh {tuple(xh.shape)}, dA_log "
                         f"{tuple(dA_log.shape)}, B_s {tuple(B_s.shape)}, "
                         f"C_s {tuple(C_s.shape)}")
    if not (xh.device == dA_log.device == B_s.device == C_s.device):
        raise ValueError("ssd_scan inputs must be on one device")


def ssd_scan_fwd(xh, dA_log, B_s, C_s, *, chunk: int = 128):
    """Forward only. CPU tensors run `ssd_chunked`; CUDA tensors launch
    the kernel or raise. On the card: xh and dA_log float32 and
    contiguous, B_s and C_s float32 or bfloat16 (one for both) with a
    contiguous last dimension (other strides are free), chunk <= 128 and
    the block's shared memory within the card's limit. Outputs are
    allocated here; the kernel runs on the current stream."""
    _check(xh, dA_log, B_s, C_s)
    if xh.device.type == "cpu":
        return ssd_chunked(xh, dA_log, B_s, C_s, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                         f"{xh.device.type}")
    B, S, H, P = xh.shape
    N = B_s.shape[-1]
    Q = pick_chunk(S, chunk)
    if xh.dtype != torch.float32 or dA_log.dtype != torch.float32:
        raise ValueError(f"xh and dA_log must be float32, not "
                         f"{xh.dtype}/{dA_log.dtype}")
    if B_s.dtype != C_s.dtype or B_s.dtype not in _DTYPES:
        raise ValueError(f"B_s/C_s dtypes {B_s.dtype}/{C_s.dtype}: the "
                         "kernel takes float32 or bfloat16, one for both")
    if not (xh.is_contiguous() and dA_log.is_contiguous()):
        raise ValueError("xh and dA_log must be contiguous")
    if B_s.stride(2) != 1 or C_s.stride(2) != 1:
        raise ValueError("the last dimension of B_s and C_s must be "
                         "contiguous")
    if Q > MAX_CHUNK or smem_bytes(Q, N) > SMEM_LIMIT:
        raise ValueError(f"chunk {Q} with state dim {N} does not fit the "
                         f"kernel (chunk <= {MAX_CHUNK}, "
                         f"{smem_bytes(Q, N)} > {SMEM_LIMIT} bytes of "
                         "shared memory)")
    if B * H * ((P + PB - 1) // PB) > 2 ** 31 - 1:
        raise ValueError("grid too large")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xh.device)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _lib().repro_ssd_scan_fwd(
            xh.data_ptr(), dA_log.data_ptr(), B_s.data_ptr(),
            C_s.data_ptr(), y.data_ptr(), st.data_ptr(), _DTYPES[B_s.dtype],
            B, S, H, P, N, Q, B_s.stride(0), B_s.stride(1), C_s.stride(0),
            C_s.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError_t {err}")
    ssd_scan.launches += 1
    return y, st


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dA_log, B_s, C_s, chunk):
        ctx.save_for_backward(xh, dA_log, B_s, C_s)
        ctx.chunk = chunk
        return ssd_scan_fwd(xh, dA_log, B_s, C_s, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gst):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        diff = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, st = ssd_chunked(*inputs, ctx.chunk)
            outs, grads = [y], [gy]
            if gst is not None:
                outs.append(st)
                grads.append(gst)
            got = iter(torch.autograd.grad(outs, diff, grads,
                                           allow_unused=True))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None,)


def ssd_scan(xh, dA_log, B_s, C_s, *, chunk: int = 128):
    """(y (B,S,H,P) f32, final state (B,H,P,N) f32), differentiable:
    the kernel forward (plain version on CPU tensors) and the plain
    chunked VJP."""
    return _SSDScan.apply(xh, dA_log, B_s, C_s, chunk)


ssd_scan.launches = 0
