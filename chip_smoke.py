#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, one nvcc per source at once;
     the tensor-core flash instances must not spill, and the Python
     mirrors of the launch arithmetic that the CPU tests check must
     agree with the libraries' own numbers;
  3. kernels: each kernel against its plain PyTorch version on the card
     (the flash-attention cases of tests/test_kernels.py in f32, on the
     FMA kernel, and in bf16, on the tensor-core kernel, plus the serve
     prefill shapes and the recurrentgemma-9b MQA shapes at head_dim 256;
     the SSD-scan cases of tests/test_kernels.py plus the mamba2-2.7b
     training shape with bf16 B/C; the RG-LRU cases of
     tests/test_kernels.py plus the recurrentgemma-9b shape, forward and
     the backward's reverse mode, and log_a down to -20), and, at the
     main paths' shapes, each kernel's time beside the plain version's, a
     library call's where one exists, and the card's bound (one call per
     CUDA-event pair, and back to back); one full-width mamba2 layer and one full-width rglru mixer through the
     kernel against the plain path;
  4. serve: the paper's GPT (gpt-h8192-l4, random weights from seed 0)
     through `repro_torch.launch.serve`, paged KV with quantum
     preemption evicting pages through the spool to a directory, then
     the same trace on the dense cache. Tokens and every logits row
     must be bitwise equal, every evicted page restored, the spool
     directory empty after close, and the kernel launched once per
     layer per prefill in the paged run;
  5. train: mamba2-2.7b at full width (64 layers, random weights from
     seed 0) through `repro_torch.session.TrainSession`, adamw, B=1,
     S=1024, 3 steps on the SSD-scan kernel, once with every residual
     kept on the card and once spooled to a fresh directory (fs, raw).
     Losses and final parameters must be bitwise equal, the spool run's
     peak device memory lower, bytes offloaded, every stored stage
     fetched, the directory empty after close, and the kernel launched
     once per layer per step in each run; one full-width layer through
     the kernel must agree with the plain path;
  6. policy matrix at a depth-8 cut: Recompute, Adaptive on fs and on
     mem, the mem backend and the zlib codec, each bitwise equal to
     Keep; every spool run reads blobs back (the zlib run waits for its
     layer stores before backward, so every layer goes through the codec
     both ways on the card); each adaptive plan is the one the paper's
     rule gives for the profiled stages and the calibrated write rate,
     and its steps read blobs back where it stores bytes;
  7. train: recurrentgemma-9b at full width (38 layers: 12 super-layers
     of rglru, rglru, local attention and a remainder of two rglru
     blocks; random weights from seed 0) through `TrainSession`, sgd
     (lr 3e-4, no momentum, clip 1.0), B=1, S=2048, 3 steps on the
     RG-LRU and flash kernels, kept and spooled (fs, raw). The checks of
     phase 5, with the stage count taken from the engine (15 stages),
     and the RG-LRU kernel launched once per rglru block per step in
     forward and once in backward, the flash kernel once per attention
     block per step;
  8. a `kernels` JSON line, the nvidia-smi line, and the result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# cuBLAS picks a reduction split per call unless its workspace is pinned:
# the keep/spool parity of phases 5-6 needs one order (set before any
# CUDA context exists)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "gpt-h8192-l4"
SERVE_ARGS = ["--arch", ARCH, "--seed", "0", "--device", "cuda",
              "--cache", "paged", "--batch", "4", "--requests", "12",
              "--prompt-len", "1024", "--max-new", "24",
              "--cache-len", "1056", "--page-tokens", "16", "--quantum", "8",
              "--kv-backend", "fs", "--kv-codec", "raw"]

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): tests/test_kernels.py
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (2, 64, 64, 4, 1, 32, True, 0, 0.0),
    (1, 128, 128, 2, 2, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),
    (1, 96, 96, 2, 2, 32, True, 0, 0.0),
    (1, 16, 16, 2, 2, 128, True, 0, 0.0),
]
TOL_F32 = 2e-5
# bf16 attention against the f32 reference, per row: 2^-6 of the row's
# largest |output|. The output's own bf16 rounding is at most 2^-8 of it,
# and the tensor-core kernel's bf16 P adds about as much again (the
# source's header note); a mask a few keys off, or a coarser P, breaks it
TOL_BF16_ROW = 2 ** -6
# full-width prefill logits, kernel vs plain attention path: both bf16
# models, so they differ by bf16 roundings of the attention output that
# propagate through 4 layers (4 bf16 ulps at |logit| ~ 8)
TOL_E2E = 0.25

# (B, S, H, P, N, chunk): tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (2, 96, 2, 16, 8, 32),
]
TOL_SSD = 2e-4
# the training shape with bf16 B/C: kernel and plain version read the same
# bf16 values and both sum in f32, so only the order of the N=128 and
# Q=128 sums differs; relative to the output's scale
TOL_SSD_PATH = 1e-5
# one full-width mamba2 layer, kernel vs plain scan: bf16 outputs, so one
# or two bf16 roundings (2**-7 relative) of the output's scale
TOL_LAYER = 2 ** -6
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ = "mamba2-2.7b", 3, 1024
MATRIX_DEPTH = 8

# (B, S, W): tests/test_kernels.py::RGLRU_CASES (their chunk and block
# width are the Pallas kernel's tiling, which the CUDA kernel has not)
RGLRU_CASES = [(1, 64, 16), (2, 128, 32), (1, 100, 8)]
TOL_RGLRU = 1e-5
# recurrentgemma-9b's attention at head_dim 256: (B, S, Hq, Hkv, D,
# causal, window, dtype, tol); the path's shape (window 2048 masks
# nothing at S=2048), a window that masks at S=4096, and an f32 case
FLASH_D256_CASES = [
    (1, 2048, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 4096, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 512, 16, 1, 256, True, 128, torch.float32, TOL_F32),
]
RG_ARCH, RG_SEQ, RG_LR, RG_CLIP = "recurrentgemma-9b", 2048, 3e-4, 1.0

# Published dense peaks (NVIDIA data sheets): memory bytes/s, and
# operations/s for bf16 on the tensor cores and f32 on the CUDA cores.
PEAKS = {
    "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12},
    "nvl": {"bytes": 3.9e12, "bfloat16": 835e12, "float32": 60e12},
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def peaks_for(name):
    n = name.lower()
    return PEAKS["pcie" if "pcie" in n else "nvl" if "nvl" in n else "sxm"]


def time_ms(fn, runs=30, warmup=3):
    """Median over `runs` of one call timed with CUDA events (the host's
    launch overhead included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_back_to_back_ms(fn, runs=30, batch=10):
    """Median over `runs` CUDA-event pairs, each around `batch` calls back
    to back, divided by the batch: the host enqueues ahead of the card, so
    its launch overhead hides behind the card's work, as on the main
    paths. A second yardstick beside `time_ms`, never mixed with it."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def attn_error(out, want, tol):
    """(max abs error, max error relative to its row's largest |output|,
    within the bar) of attention `out` against the f32 reference `want`:
    f32 at `tol` abs + rel per element, bf16 at `tol` of each row's
    largest |output| (TOL_BF16_ROW)."""
    d = (out.float() - want).abs()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    if out.dtype == torch.float32:
        ok = bool(torch.all(d <= tol + tol * want.abs()))
    else:
        ok = bool(torch.all(d <= tol * rowmax))
    rel = (d / rowmax.clamp_min(1e-30)).max().item()
    return d.max().item(), rel, ok and math.isfinite(d.max().item())


def mount_of(path):
    """(mount point, filesystem type) holding `path`, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return best


def ptxas_report(log):
    """One line per kernel instance from `nvcc -Xptxas -v` output: its
    name with the template arguments of the mangled name (D=256 on the
    tensor cores reads `attn_fwd_mma_kernel<256>`, the RG-LRU reverse mode
    `rglru_scan_kernel<true>`, an SSD pass on bf16 B/C
    `ssd_states_kernel<bf16>`), then registers and spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*kernel)(?:I(\w+?)E)?E", line)
        if "Compiling entry" in line and m:
            args = (m.group(2) or "").replace("Lb0", "false,")
            args = args.replace("Lb1", "true,")
            args = re.sub(r"Li(\d+)E?", r"\1,", args)
            args = args.replace("13__nv_bfloat16", "bf16").rstrip(",")
            args = re.sub(r"(^|,)f$", r"\1f32", args)
            name = f"{m.group(1)}<{args}>" if args else m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def mirror_check():
    """The Python mirrors of the launch arithmetic that the CPU tests
    check (`flash_plan`, `kv_tiles`, `warp_live`, `ssd_plan`) against the
    built libraries' own numbers: every flash instance's constants, the
    kv tiles of every q tile and the live tiles of every warp at the
    attention cases and the path shapes, and the SSD passes at the SSD
    cases and the training shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    shapes = ATTN_CASES + [(1, S, S, 64, 64, 128, True, 0, 0.0)
                           for S in (1024, 1000)]
    shapes += [(B, S, S, Hq, Hkv, D, causal, window, 0.0) for
               B, S, Hq, Hkv, D, causal, window, _, _ in FLASH_D256_CASES]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in fa.HEAD_DIMS:
            plan = fa.flash_plan(D, dtype)
            check(plan == fa.library_plan(D, dtype), f"flash_plan({D}, "
                  f"{dtype}) {plan} is not the library's "
                  f"{fa.library_plan(D, dtype)}")
            n += 1
        for B, Sq, Skv, Hq, Hkv, D, causal, window, _ in shapes:
            plan = fa.flash_plan(D, dtype)
            bq, bk = plan["bq"], plan["bk"]
            for q0 in range(0, Sq, bq):
                tiles = fa.kv_tiles(q0, bq, bk, Sq, Skv, causal, window)
                check(tiles == fa.library_kv_tiles(D, dtype, q0, Sq, Skv,
                                                   causal, window),
                      f"kv_tiles differs from the library at D={D} "
                      f"{dtype} Sq={Sq} q0={q0}")
                n += 1
                if dtype != torch.bfloat16:
                    continue
                for t in tiles:
                    for r_lo in range(q0, q0 + bq, 16):
                        check(fa.warp_live(t * bk, r_lo, bk, Sq, causal,
                                           window)
                              == fa.library_warp_live(D, t * bk, r_lo, Sq,
                                                      causal, window),
                              f"warp_live differs from the library at D={D}"
                              f" Sq={Sq} tile {t} rows {r_lo}")
                        n += 1
    for B, S, H, P, N, chunk in SSD_CASES + [(1, TRAIN_SEQ, 80, 64, 128,
                                              128)]:
        Q = ssd.pick_chunk(S, chunk)
        mine = ssd.ssd_plan(B, S, H, P, N, Q)["passes"]
        check(mine == ssd.library_plan(B, S, H, P, N, Q),
              f"ssd_plan {mine} is not the library's "
              f"{ssd.library_plan(B, S, H, P, N, Q)}")
        n += 1
    print(f"  launch arithmetic: the Python mirrors agree with the "
          f"libraries in {n} checks")


def unmasked_pairs(Sq, Skv, causal, window):
    """(row, col) score pairs the masks keep: the work this input needs."""
    total = 0
    for r in range(Sq):
        hi = min(Skv, r + 1) if causal else Skv
        lo = max(0, r - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def bound_ms(q, k, v, causal, window, peaks):
    """Least time for the card: each input read once and the output
    written once over the memory rate, or the score and value products
    of the unmasked pairs over the peak rate of the input type."""
    B, Sq, Hq, D = q.shape
    nbytes = 2 * q.numel() * q.element_size() + k.numel() * k.element_size() \
        + v.numel() * v.element_size()
    flops = 4 * B * Hq * D * unmasked_pairs(Sq, k.shape[1], causal, window)
    t_bytes = nbytes / peaks["bytes"]
    t_ops = flops / peaks[str(q.dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_bound_ms(xh, dA_log, B_s, C_s, chunk, peaks):
    """Least time for the SSD scan: inputs read once and y and the final
    state written once over the memory rate, or the products the
    chunked algorithm needs (C B^T once per chunk, then per head the
    causal Q x Q x P product, C state^T and the state update) over the
    f32 rate (the kernel computes in f32, as the TPU kernel does)."""
    from repro_torch.kernels.ssd_scan import pick_chunk
    B, S, H, P = xh.shape
    N = B_s.shape[-1]
    Q = pick_chunk(S, chunk)
    nc = S // Q
    tri = Q * (Q + 1) // 2
    nbytes = (2 * xh.numel() * 4 + dA_log.numel() * 4
              + 2 * B_s.numel() * B_s.element_size() + B * H * P * N * 4)
    flops = 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))
    t_bytes = nbytes / peaks["bytes"]
    t_ops = flops / peaks["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_phase(gen, peaks, smi):
    """The SSD-scan kernel against its plain version; its time at the
    training shape. Returns (worst error of the cases at the 2e-4 bar,
    the training shape's error relative to its output scale, kernel_ms,
    plain_ms, bound, back-to-back kernel ms)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_fwd

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    worst = 0.0
    for B, S, H, P, N, chunk in SSD_CASES:
        xh, a = rand((B, S, H, P)), -rand((B, S, H), 0.2).abs()
        Bs, Cs = rand((B, S, N)), rand((B, S, N))
        y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=chunk)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(xh, a, Bs, Cs, chunk)
        ok = all(bool(torch.all((g - w).abs() <= TOL_SSD + TOL_SSD * w.abs()))
                 for g, w in ((y, yr), (st, sr)))
        err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
        worst = max(worst, err)
        print(f"  ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
              f"float32: max_abs_err {err:.3e} tol {TOL_SSD:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), "ssd_scan disagrees with its plain "
              "version")
    # the training shape: B and C are bf16 column slices of the conv
    # output (strided views), decays of full-width size (dt ~ softplus)
    conv = rand((1, 1024, 5376)).bfloat16()
    Bs, Cs = conv[..., 5120:5248], conv[..., 5248:]
    xh = rand((1, 1024, 80, 64))
    a = -torch.nn.functional.softplus(rand((1, 1024, 80)))
    y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)
    torch.cuda.synchronize()
    yr, sr = ssd_chunked(xh, a, Bs, Cs, 128)
    scale = yr.abs().max().item()
    err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
    ok = err <= TOL_SSD_PATH * scale and bool(torch.isfinite(y).all())
    print(f"  ssd_scan training shape B=1 S=1024 H=80 P=64 N=128 chunk=128 "
          f"bf16 B/C: max_abs_err {err:.3e} (output scale {scale:.1f}, "
          f"tol {TOL_SSD_PATH:g} relative) {'ok' if ok else 'FAIL'}")
    check(ok, "ssd_scan disagrees with its plain version at the training "
          "shape")
    kernel_ms = time_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs, chunk=128))
    b2b_ms = time_back_to_back_ms(lambda: ssd_scan_fwd(xh, a, Bs, Cs,
                                                       chunk=128))
    plain_ms = time_ms(lambda: ssd_chunked(xh, a, Bs, Cs, 128))
    b_ms, b_by = ssd_bound_ms(xh, a, Bs, Cs, 128, peaks)
    print(f"  ssd_scan training shape: kernel_ms {kernel_ms:.4f} "
          f"(back-to-back {b2b_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
          f"none (no single PyTorch call computes the SSD scan) bound_us "
          f"{1e3 * b_ms:.1f} ({b_by}) on {smi}")
    return worst, err / scale, kernel_ms, plain_ms, (b_ms, b_by), b2b_ms


def rglru_bound_ms(log_a, x, peaks):
    """Least time for the RG-LRU scan: log_a and x read once and h written
    once over the memory rate, or one exp and one FMA per element over the
    f32 rate (the memory side bounds it by far)."""
    nbytes = 3 * x.numel() * 4
    flops = 2 * x.numel()
    t_bytes = nbytes / peaks["bytes"]
    t_ops = flops / peaks["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rglru_phase(gen, peaks, smi):
    """The RG-LRU kernel against its plain version, both modes (forward,
    and the reverse recurrence its backward runs); its time at the
    recurrentgemma-9b shape. Returns (worst error, kernel_ms, plain_ms,
    bound, back-to-back kernel ms)."""
    from repro_torch.kernels.rglru_scan import (rglru_scan_fwd,
                                                rglru_sequential)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [(c, 0.5) for c in RGLRU_CASES] + [((1, RG_SEQ, 4096), 0.5),
                                              ((1, RG_SEQ, 4096), 20.0)]
    worst = 0.0
    for (B, S, W), depth in cases:
        if depth == 0.5:        # -|N(0, 0.5)|, the JAX tests' decays
            la = -(rand((B, S, W)) * 0.5).abs()
        else:                   # uniform in [-20, 0]
            la = -torch.rand((B, S, W), generator=gen, device="cuda") * 20
        x = rand((B, S, W))
        for reverse in (False, True):
            h = rglru_scan_fwd(la, x, reverse=reverse)
            torch.cuda.synchronize()
            want = rglru_sequential(la, x, reverse=reverse)
            err = (h - want).abs().max().item()
            ok = bool(torch.all((h - want).abs()
                                <= TOL_RGLRU + TOL_RGLRU * want.abs()))
            worst = max(worst, err)
            print(f"  rglru_scan B={B} S={S} W={W} log_a "
                  f"{'-|N(0,0.5)|' if depth == 0.5 else 'U[-20,0]'} "
                  f"{'reverse' if reverse else 'forward'}: max_abs_err "
                  f"{err:.3e} tol {TOL_RGLRU:g} {'ok' if ok else 'FAIL'}")
            check(ok and math.isfinite(err), "rglru_scan disagrees with its "
                  "plain version")
    la = -(rand((1, RG_SEQ, 4096)) * 0.5).abs()
    x = rand((1, RG_SEQ, 4096))
    kernel_ms = time_ms(lambda: rglru_scan_fwd(la, x))
    b2b_ms = time_back_to_back_ms(lambda: rglru_scan_fwd(la, x))
    plain_ms = time_ms(lambda: rglru_sequential(la, x))
    b_ms, b_by = rglru_bound_ms(la, x, peaks)
    print(f"  rglru_scan recurrentgemma-9b shape B=1 S={RG_SEQ} W=4096 f32: "
          f"kernel_ms {kernel_ms:.4f} (back-to-back {b2b_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms none (no single PyTorch call computes "
          f"this scan) bound_us {1e3 * b_ms:.1f} ({b_by}) on {smi}")
    return worst, kernel_ms, plain_ms, (b_ms, b_by), b2b_ms


def flash_d256_phase(gen, peaks, smi):
    """The flash kernel at recurrentgemma-9b's MQA head_dim 256 against
    the plain attention; at the path's shape its time beside the bound
    and scaled_dot_product_attention's. Returns (worst bf16 error,
    kernel_ms, plain_ms, library_ms, bound, back-to-back kernel ms)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    worst, path = 0.0, None
    for B, S, Hq, Hkv, D, causal, window, dtype, tol in FLASH_D256_CASES:
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
        err, rel, ok = attn_error(out, want, tol)
        print(f"  flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"causal={causal} window={window} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} row_rel_err {rel:.3e} tol {tol:g}"
              f"{' of the row max' if dtype == torch.bfloat16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "flash_attention disagrees with its plain version at "
              "head_dim 256")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        if path is None:
            path = (q, k, v, window)
    q, k, v, window = path
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                window=window))
    b2b_ms = time_back_to_back_ms(lambda: flash_attention(
        q, k, v, causal=True, window=window))
    plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True,
                                                   window=window))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True))
    b_ms, b_by = bound_ms(q, k, v, True, window, peaks)
    B, S, Hq, D = q.shape
    print(f"  recurrentgemma-9b shape B={B} S={S} Hq={Hq} Hkv={k.shape[2]} "
          f"D={D} causal window {window} bf16: kernel_ms {kernel_ms:.4f} "
          f"(back-to-back {b2b_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} "
          f"(scaled_dot_product_attention, yardstick only) bound_us "
          f"{1e3 * b_ms:.1f} ({b_by}) on {smi}")
    return worst, kernel_ms, plain_ms, library_ms, (b_ms, b_by), b2b_ms


def rg_layer_check(gen):
    """One full-width rglru mixer forward through the kernel against the
    plain recurrence, bf16 weights from a seed."""
    from repro_torch.configs import resolve_config
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models.rglru import apply_rglru, init_rglru
    cfg = resolve_config(RG_ARCH)
    p = init_rglru(gen, cfg, torch.bfloat16)
    x = torch.randn((1, RG_SEQ, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        before = rglru_scan.launches
        yk, _ = apply_rglru(p, x, cfg, impl="cuda")
        check(rglru_scan.launches == before + 1, "the rglru mixer did not "
              "launch the rglru_scan kernel")
        yp, _ = apply_rglru(p, x, cfg, impl="torch")
    scale = yp.float().abs().max().item()
    err = (yk.float() - yp.float()).abs().max().item()
    print(f"  one {RG_ARCH} rglru mixer, kernel vs plain recurrence: "
          f"max_abs_err {err:.3e} (output scale {scale:.3f}, tol "
          f"{TOL_LAYER:g} relative)")
    check(bool(torch.isfinite(yk).all()) and err <= TOL_LAYER * scale,
          "the rglru mixer through the kernel differs from the plain path")


def layer_check(gen):
    """One full-width mamba2 layer forward through the kernel against the
    plain scan, bf16 weights from a seed."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.mamba2 import apply_mamba2, init_mamba2
    cfg = resolve_config(TRAIN_ARCH)
    p = init_mamba2(gen, cfg, torch.bfloat16)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    from repro_torch.kernels.ssd_scan import ssd_scan
    with torch.no_grad():
        before = ssd_scan.launches
        yk, _ = apply_mamba2(p, x, cfg, impl="cuda")
        check(ssd_scan.launches == before + 1, "the layer did not launch "
              "the ssd_scan kernel")
        yp, _ = apply_mamba2(p, x, cfg, impl="torch")
    scale = yp.float().abs().max().item()
    err = (yk.float() - yp.float()).abs().max().item()
    print(f"  one {TRAIN_ARCH} layer, kernel vs plain scan: max_abs_err "
          f"{err:.3e} (output scale {scale:.3f}, tol {TOL_LAYER:g} "
          f"relative)")
    check(bool(torch.isfinite(yk).all()) and err <= TOL_LAYER * scale,
          "the mamba2 layer through the kernel differs from the plain path")


def drained_spool_policy():
    """A SpoolPolicy that, before the head stage is stored, waits for the
    store of every earlier stage to land: backward then reads each layer
    back through the backend and the codec instead of forwarding the
    host copy of a store still queued (zlib encodes slower than 8 layers
    run forward, so without the wait nothing would be read back)."""
    from repro_torch.core.policies import SpoolPolicy

    class DrainedSpoolPolicy(SpoolPolicy):
        spool = None

        def should_offload(self, stage, profile=None):
            if profile is not None and profile.name == "head":
                self.spool.wait_io()
            return True

    return DrainedSpoolPolicy()


def train_run(cfg, policy, io, label, *, optimizer="adamw", seq=TRAIN_SEQ,
              keep_params=None):
    """TrainSession steps at B=1, S=seq on the card. Every kernel's launch
    count is set to 0 just before the steps and read just after. Returns
    (losses, params, reports, {kernel: launches}, run peak, stage
    count): params are the final parameters on the host, or, given the
    host parameters of an earlier run as `keep_params`, whether they are
    bitwise equal to those (one host copy of a large model, not two)."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.session import TrainSession
    kernels = (flash_attention, ssd_scan, rglru_scan)
    sess = TrainSession(cfg, policy=policy, io=io, optimizer=optimizer,
                        lr=3e-4, batch_size=1, seq_len=seq, seed=0,
                        device="cuda", attn_impl="cuda")
    if hasattr(policy, "spool"):
        policy.spool = sess.spool
    try:
        sess.init()
        for k in kernels:
            k.launches = 0
        result = sess.run(TRAIN_STEPS)
        launches = {k.__name__: k.launches for k in kernels}
        n_stages = len(sess.engine.stage_names)
        leaves = tree_flatten(sess.params)[0]
        if keep_params is None:
            params = [t.detach().cpu() for t in leaves]
        else:
            params = same_params(leaves, keep_params)
        del leaves
        for r in result.reports:
            st, ex = r.stats, r.extra
            print(f"  {label} step {r.step}: loss {r.loss:.6f} "
                  f"{r.step_time:.3f}s (fwd {ex['forward_s']:.3f} bwd "
                  f"{ex['backward_s']:.3f} opt {ex['optimizer_s']:.3f}) "
                  f"peak {ex['device_peak_bytes'] / 1e9:.2f}"
                  f" GB bwd-begin {ex['device_backward_begin_bytes'] / 1e9:.2f}"
                  f" GB (tracked act {r.backward_begin_bytes / 1e9:.2f} GB) "
                  f"offloaded {st.bytes_offloaded / 1e9:.3f} GB (of "
                  f"{st.bytes_offloaded_logical / 1e9:.3f} GB before the "
                  f"codec) loaded "
                  f"{st.bytes_loaded / 1e9:.3f} GB forwarded "
                  f"{st.bytes_forwarded / 1e9:.3f} GB store {st.store_time:.2f}s"
                  f" load {st.load_time:.2f}s fetch wait "
                  f"{st.fetch_wait_time:.3f}s stages off/kept/recomp/fetched "
                  f"{ex['stages_offloaded']}/{ex['stages_kept']}/"
                  f"{ex['stages_recomputed']}/{ex['stages_fetched']}")
        reports = result.reports
        losses = [r.loss for r in reports]
        peak = max(r.extra["device_peak_bytes"] for r in reports)
    finally:
        sess.close()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    return losses, params, reports, launches, peak, n_stages


def deterministic():
    """Deterministic kernels for the parity phases (warn, not raise, on an
    op without one: the bitwise checks catch any that matters), without
    the NaN fill of every new tensor that the mode turns on by default."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def same_params(a, b) -> bool:
    """Leaf lists bitwise equal (b's leaves are moved to a's device one
    at a time)."""
    return len(a) == len(b) and all(torch.equal(x, y.to(x.device))
                                    for x, y in zip(a, b))


def keep_vs_spool(cfg, seq, optimizer, want, smi):
    """Full-width training of `cfg` kept on the card, then spooled (fs,
    raw) to a fresh directory: bitwise losses and parameters, a lower
    peak, bytes offloaded, every stored stage fetched (the stage count
    is the engine's), the directory empty after close, and each kernel's
    launches equal to `want` in each run. Returns the spool run's
    launches (the main path's)."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.policies import KeepPolicy, SpoolPolicy
    deterministic()
    lk, pk, _, nk, peak_k, _ = train_run(cfg, KeepPolicy(), None,
                                         f"{cfg.name} keep",
                                         optimizer=optimizer, seq=seq)
    spool_dir = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    mnt, fstype = mount_of(spool_dir)
    ls, same, rs, ns, peak_s, n_stages = train_run(
        cfg, SpoolPolicy(), SpoolIoConfig(backend="fs", directory=spool_dir,
                                          codec="raw"), f"{cfg.name} spool",
        optimizer=optimizer, seq=seq, keep_params=pk)
    n_leaves = len(pk)
    del pk
    left = os.listdir(spool_dir)
    if not left:
        os.rmdir(spool_dir)
    print(f"train: {cfg.name} {cfg.num_layers} layers in {n_stages} "
          f"stages, d_model {cfg.d_model}, {TRAIN_STEPS} steps at B=1 "
          f"S={seq}; keep losses {lk}, spool losses {ls}; peak device "
          f"memory keep {peak_k / 1e9:.2f} GB, spool {peak_s / 1e9:.2f} GB;"
          f" launches keep {nk}, spool {ns}; spool dir on {mnt} ({fstype}) "
          f"on {smi}")
    check(lk == ls, f"keep and spool losses differ: {lk} vs {ls}")
    check(same, "keep and spool parameters differ")
    check(peak_s < peak_k, f"spool peak {peak_s} not below keep {peak_k}")
    check(sum(r.stats.bytes_offloaded for r in rs) > 0, "nothing offloaded")
    check(all(r.extra["stages_offloaded"] == r.extra["stages_fetched"]
              == n_stages for r in rs), "a stored stage was not fetched")
    check(not left, f"spool directory not empty after close: {left[:5]}")
    for name, n in want.items():
        check(nk[name] == ns[name] == n, f"{name} launches "
              f"{nk[name]}/{ns[name]}, want {n}")
    print(f"  keep vs spool: losses and {n_leaves} parameter leaves bitwise "
          f"equal")
    return ns


def train_phase(smi):
    """Full-width mamba2-2.7b with adamw: the SSD kernel once per layer
    per step."""
    from repro_torch.configs import resolve_config
    cfg = resolve_config(TRAIN_ARCH)
    return keep_vs_spool(cfg, TRAIN_SEQ, "adamw",
                         {"ssd_scan": cfg.num_layers * TRAIN_STEPS}, smi)


def rg_train_phase(smi):
    """Full-width recurrentgemma-9b with sgd (no momentum: adamw's f32
    moments, 83.6 GB, pass one card): the RG-LRU kernel once per rglru
    block per step in forward and once in backward, the flash kernel once
    per attention block per step (its backward is the plain VJP)."""
    from repro_torch.configs import resolve_config
    from repro_torch.optim.optimizers import sgd
    from repro_torch.models.api import build_model
    cfg = resolve_config(RG_ARCH)
    kinds = [b.mixer for seg in build_model(cfg).segments
             for _ in range(seg.n_repeat) for b in seg.blocks]
    return keep_vs_spool(
        cfg, RG_SEQ, sgd(RG_LR, clip_norm=RG_CLIP),
        {"rglru_scan": 2 * kinds.count("rglru") * TRAIN_STEPS,
         "flash_attention": kinds.count("attn") * TRAIN_STEPS,
         "ssd_scan": 0}, smi)


def adaptive_check(label, policy, reps):
    """The adaptive plan against the paper's rule (§3.3.3), worked here
    from the profiled stages and the calibrated write rate: offloading
    stages 0..m needs (bytes of 0..m-1 + 2 x bytes of m) / (forward time
    of 1..m + (1 + bwd_factor) x forward time of m+1..) within the rate,
    and the plan takes the largest such m short of the last stage. The
    profiling step offloads every stage and reads blobs back. A planned
    step reads blobs back where it stores bytes, and it does store bytes
    where its plan holds a layer stage (the embed stage's saved token ids
    fall under the spool's size filter)."""
    prof, bw, plan = policy.profiles, policy.bandwidths, policy.plan
    nbytes = [p.bytes for p in prof]
    fwd = [p.fwd_time for p in prof]

    def need(m):
        deadline = sum(fwd[1:m + 1]) + (1 + policy.bwd_factor) * sum(
            fwd[m + 1:])
        nb = sum(nbytes[:m]) + 2 * nbytes[m]
        return nb / deadline if deadline > 0 else float("inf")

    want = max((m for m in range(len(prof) - 1) if need(m) <= bw),
               default=-1)
    m = plan.last_offloaded
    print(f"  d{MATRIX_DEPTH} {label}: calibrated write rate "
          f"{bw / 1e9:.3f} GB/s, profiled forward {sum(fwd):.4f} s over "
          f"{len(prof)} stages; plan 0..{m} needs "
          f"{plan.required_bw / 1e9:.3f} GB/s"
          + (f", 0..{m + 1} would need {need(m + 1) / 1e9:.3f} GB/s"
             if m + 1 < len(prof) - 1 else "")
          + f"; planned steps store "
          f"{[r.stats.bytes_offloaded for r in reps[1:]]} bytes")
    check(m == want and plan.offload == [i <= want
                                         for i in range(len(prof))],
          f"{label}: plan 0..{m}, the rule gives 0..{want}")
    check(reps[0].stats.bytes_loaded > 0,
          f"{label}: the profiling step read nothing back")
    for r in reps[1:]:
        if m >= 1:
            check(r.stats.bytes_offloaded > 0,
                  f"{label}: a plan with layer stages stored nothing")
        if r.stats.bytes_offloaded > 0:
            check(r.stats.bytes_loaded > 0,
                  f"{label}: a planned step read nothing back")


def matrix_phase():
    """Depth-cut policy matrix: every run bitwise equal to keep, and
    every run that offloads reads blobs back."""
    from repro_torch.configs import SpoolIoConfig, resolve_config
    from repro_torch.core.policies import (AdaptivePolicy, KeepPolicy,
                                           RecomputePolicy, SpoolPolicy)
    cfg = dataclasses.replace(resolve_config(TRAIN_ARCH),
                              num_layers=MATRIX_DEPTH)
    deterministic()
    lk, pk, _, _, _, _ = train_run(cfg, KeepPolicy(), None,
                                   f"d{MATRIX_DEPTH} keep")
    # Adaptive plans the offloaded prefix from the profiled forward time
    # and the backend's calibrated write rate, so on a slow directory the
    # plan may hold no layer stage: it is held to its own arithmetic
    # (adaptive_check) and must read blobs back where it stores bytes
    runs = [("recompute", RecomputePolicy(), None, 2),
            ("adaptive fs raw", AdaptivePolicy(),
             SpoolIoConfig(backend="fs", codec="raw"), 1),
            ("adaptive mem raw", AdaptivePolicy(),
             SpoolIoConfig(backend="mem", codec="raw"), 1),
            ("spool mem raw", SpoolPolicy(),
             SpoolIoConfig(backend="mem", codec="raw"), 1),
            ("spool fs zlib", drained_spool_policy(),
             SpoolIoConfig(backend="fs", codec="zlib"), 1)]
    for label, policy, io, fwd_per_layer in runs:
        l, same, reps, launches, peak, _ = train_run(
            cfg, policy, io, f"d{MATRIX_DEPTH} {label}", keep_params=pk)
        n = launches["ssd_scan"]
        plan = reps[-1].plan
        print(f"  d{MATRIX_DEPTH} {label}: losses {l} peak "
              f"{peak / 1e9:.2f} GB ssd launches {n}"
              + (f" plan offloads stages 0..{plan.last_offloaded}"
                 if plan is not None else ""))
        check(l == lk, f"{label}: losses differ from keep: {l} vs {lk}")
        check(same, f"{label}: parameters differ from keep")
        check(n == fwd_per_layer * MATRIX_DEPTH * TRAIN_STEPS,
              f"{label}: {n} ssd_scan launches")
        if label.startswith("adaptive"):
            adaptive_check(label, policy, reps)
        elif label != "recompute":
            check(all(r.stats.bytes_loaded > 0 for r in reps),
                  f"{label}: a step read nothing back from the spool")
        if "zlib" in label:
            check(all(r.stats.num_loads >= MATRIX_DEPTH for r in reps),
                  f"{label}: the layer stages were forwarded, not read "
                  f"back through the codec")
    print(f"  policy matrix at depth {MATRIX_DEPTH}: every run bitwise "
          f"equal to keep")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    from repro_torch.kernels.ssd_scan import KERNELS_PER_CALL
    from repro_torch.launch import serve
    from repro_torch.models.transformer import RunSettings

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = peaks_for(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f}s")
    for src in libs:
        for line in ptxas_report(build.build_log(src)):
            print(f"  ptxas {src}: {line}")
            if line.startswith("attn_fwd_mma_kernel"):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"a tensor-core flash instance spills: {line}")
    mirror_check()

    # ---- 3. kernel vs plain version
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [(c, torch.float32, TOL_F32) for c in ATTN_CASES]
    cases += [(c, torch.bfloat16, TOL_BF16_ROW) for c in ATTN_CASES]
    cases += [((1, S, S, 64, 64, 128, True, 0, 0.0), torch.bfloat16,
               TOL_BF16_ROW) for S in (1024, 1000)]
    worst = worst_rel = 0.0
    serve_inputs = None
    for (B, Sq, Skv, Hq, Hkv, D, causal, window, cap), dtype, tol in cases:
        q, k, v = (rand((B, Sq, Hq, D), dtype), rand((B, Skv, Hkv, D), dtype),
                   rand((B, Skv, Hkv, D), dtype))
        out = flash_attention(q, k, v, causal=causal, window=window,
                              logit_cap=cap)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   logit_cap=cap)
        err, rel, ok = attn_error(out, want, tol)
        print(f"  flash_attention B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} "
              f"D={D} causal={causal} window={window} cap={cap} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} row_rel_err "
              f"{rel:.3e} tol {tol:g}"
              f"{' of the row max' if dtype == torch.bfloat16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "flash_attention disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
            worst_rel = max(worst_rel, rel)
        if Sq == 1024:
            serve_inputs = (q, k, v)
    q, k, v = serve_inputs
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    b2b_ms = time_back_to_back_ms(lambda: flash_attention(q, k, v,
                                                          causal=True))
    plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))
    b_ms, b_by = bound_ms(q, k, v, True, 0, peaks)
    print(f"  serve shape B=1 S=1024 H=64 D=128 causal bf16: kernel_ms "
          f"{kernel_ms:.4f} (back-to-back {b2b_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} "
          f"(scaled_dot_product_attention, yardstick only) "
          f"bound_us {1e3 * b_ms:.1f} ({b_by}) on {smi}")

    (ssd_err, ssd_rel, ssd_ms, ssd_plain_ms, (ssd_b_ms, ssd_b_by),
     ssd_b2b_ms) = ssd_phase(gen, peaks, smi)
    layer_check(gen)
    rg_err, rg_ms, rg_plain_ms, (rg_b_ms, rg_b_by), rg_b2b_ms = rglru_phase(
        gen, peaks, smi)
    d256 = flash_d256_phase(gen, peaks, smi)
    rg_layer_check(gen)

    # ---- 4. serve at full width
    t0 = time.perf_counter()
    rt = serve.build_runtime(ARCH, seed=0, device="cuda")
    cfg, api, params, settings = rt
    torch.cuda.synchronize()
    print(f"serve: {ARCH} weights ready in {time.perf_counter() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    n_layers = cfg.num_layers

    # end to end: one prefill through the kernel against the plain path
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        lk = api.forward(params, {"tokens": toks}, settings)
        lp = api.forward(params, {"tokens": toks},
                         RunSettings(attn_impl="torch", attn_chunk=256,
                                     param_dtype=cfg.dtype, device="cuda"))
    vocab = cfg.vocab_size
    e2e_err = (lk[..., :vocab] - lp[..., :vocab]).abs().max().item()
    agree = (lk[0, :, :vocab].argmax(-1) == lp[0, :, :vocab].argmax(-1))
    print(f"  prefill logits, kernel vs plain attention: max_abs_err "
          f"{e2e_err:.3e} (logit std {lp[..., :vocab].std().item():.3f}), "
          f"argmax agreement {agree.float().mean().item():.4f}")
    check(bool(torch.isfinite(lk[..., :vocab]).all()), "non-finite logits")
    check(e2e_err <= TOL_E2E, f"prefill logits through the kernel differ "
          f"from the plain path by {e2e_err} > {TOL_E2E}")

    kv_dir = tempfile.mkdtemp(prefix="chip_smoke_kv_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    sp, rp = serve.run(serve.parse_args(SERVE_ARGS + ["--kv-dir", kv_dir]),
                       rt, record_logits=True)
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    left = os.listdir(kv_dir)
    if not left:
        os.rmdir(kv_dir)
    for line in serve.report_lines(rp):
        print(f"  {line}")
    st = sp.cache.spool.stats
    mnt, fstype = mount_of(kv_dir)
    print(f"  spool: {st.bytes_offloaded / 1e9:.3f} GB stored in "
          f"{st.num_stores} blobs ({st.store_time:.3f}s busy summed over "
          f"store threads), {st.bytes_loaded / 1e9:.3f} GB loaded "
          f"({st.load_time:.3f}s), {st.bytes_forwarded / 1e9:.3f} GB "
          f"forwarded, {st.stores_canceled} stores cancelled, fetch wait "
          f"{st.fetch_wait_time:.3f}s; directory on {mnt} ({fstype})")
    print(f"  paged: flash_attention launches {launches} for "
          f"{rp.kv['prefills']} prefills x {n_layers} layers; peak device "
          f"memory {peak_gb:.2f} GB on {name}")
    launches0 = flash_attention.launches
    sd, rd = serve.run(serve.parse_args(SERVE_ARGS + ["--cache", "dense"]),
                       rt, record_logits=True)
    dense_launches = flash_attention.launches - launches0
    for line in serve.report_lines(rd):
        print(f"  {line}")

    check(rp.preemptions > 0, "no preemption in the paged run")
    check(rp.kv["pages_evicted"] == rp.kv["pages_restored"] > 0,
          f"pages evicted {rp.kv['pages_evicted']} != restored "
          f"{rp.kv['pages_restored']} (or none)")
    check(not left, f"spool directory not empty after close: {left[:5]}")
    check(launches == rp.kv["prefills"] * n_layers,
          f"{launches} kernel launches for {rp.kv['prefills']} prefills")
    check(dense_launches == rd.kv["prefills"] * n_layers,
          "dense run did not prefill through the kernel")
    p = {s.rid: s for s in sp.finished}
    d = {s.rid: s for s in sd.finished}
    check(set(p) == set(d) and len(p) == 12, "request sets differ")
    rows = 0
    for rid in p:
        check(p[rid].tokens == d[rid].tokens, f"tokens differ, rid {rid}")
        for a, b in zip(p[rid].logits, d[rid].logits):
            check(a.shape == (cfg.padded_vocab,) and
                  np.array_equal(a, b),
                  f"logits differ (paged vs dense), rid {rid}")
            rows += 1
    print(f"  paged vs dense: {rows} logits rows bitwise equal, tokens "
          f"equal for {len(p)} requests")
    del rt, cfg, api, params, sp, sd, lk, lp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. train mamba2 at full width, keep vs spool; 6. policy
    # matrix; 7. train recurrentgemma at full width, keep vs spool
    t0 = time.perf_counter()
    ssd_launches = train_phase(smi)["ssd_scan"]
    matrix_phase()
    t1 = time.perf_counter()
    rg_launches = rg_train_phase(smi)
    print(f"train phases: mamba2 {t1 - t0:.1f}s, recurrentgemma "
          f"{time.perf_counter() - t1:.1f}s")

    # ---- 8. result
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::_attn_kernel",
        "launches": launches,
        "launches_per_serve_run": launches,
        "max_abs_err": worst,
        "max_err": worst,
        # bf16 cases: error over the largest |output| of its row
        "max_row_rel_err": worst_rel,
        "tol": TOL_BF16_ROW,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "ms_back_to_back": b2b_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_us": 1e3 * b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "redesigned": 14,
        "ms_over_library_ms": kernel_ms / library_ms,
        "bound_over_ms": b_ms / kernel_ms,
        # recurrentgemma-9b training: MQA at head_dim 256, window 2048
        "launches_per_train_run": rg_launches["flash_attention"],
        "d256_max_abs_err": d256[0],
        "d256_ms": d256[1],
        "d256_ms_back_to_back": d256[5],
        "d256_plain_ms": d256[2],
        "d256_library_ms": d256[3],
        "d256_bound_ms": d256[4][0],
        "d256_bound_by": d256[4][1],
        "d256_ms_over_library_ms": d256[1] / d256[3],
        "d256_bound_over_ms": d256[4][0] / d256[1],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:30",
        "tpu_kernel": "src/repro/kernels/ssd_scan.py::_ssd_kernel",
        "launches": ssd_launches,
        "launches_per_train_run": ssd_launches,
        "max_abs_err": ssd_err,
        "max_err": ssd_err,
        "tol": TOL_SSD,
        # the training shape, relative to its output's scale
        "path_rel_err": ssd_rel,
        "path_tol_rel": TOL_SSD_PATH,
        "ms": ssd_ms,
        "kernel_ms": ssd_ms,
        "ms_back_to_back": ssd_b2b_ms,
        "plain_ms": ssd_plain_ms,
        "bound_ms": ssd_b_ms,
        "bound_us": 1e3 * ssd_b_ms,
        "bound_by": ssd_b_by,
        "library_ms": None,
        "redesigned": 14,
        "ms_over_library_ms": None,
        "bound_over_ms": ssd_b_ms / ssd_ms,
        "kernels_per_call": KERNELS_PER_CALL,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan_fwd.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:29",
        "tpu_kernel": "src/repro/kernels/rglru_scan.py::_rglru_kernel",
        "launches": rg_launches["rglru_scan"],
        "launches_per_train_run": rg_launches["rglru_scan"],
        "max_abs_err": rg_err,
        "max_err": rg_err,
        "tol": TOL_RGLRU,
        "ms": rg_ms,
        "kernel_ms": rg_ms,
        "ms_back_to_back": rg_b2b_ms,
        "plain_ms": rg_plain_ms,
        "bound_ms": rg_b_ms,
        "bound_us": 1e3 * rg_b_ms,
        "bound_by": rg_b_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
