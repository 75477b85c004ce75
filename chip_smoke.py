#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, one nvcc per source at once;
     the tensor-core flash instances and every RG-LRU instance must not
     spill, and the Python mirrors of the launch arithmetic that the CPU
     tests check must agree with the libraries' own numbers;
  3. kernels: each kernel against its plain PyTorch version on the card
     (the flash-attention cases of tests/test_kernels.py in f32, on the
     FMA kernel, and in bf16, on the tensor-core kernel, plus the serve
     prefill shapes, phase 8's shapes non-causal and causal, and the
     recurrentgemma-9b MQA shapes at head_dim 256;
     the SSD-scan cases of tests/test_kernels.py plus the mamba2-2.7b
     training shape with bf16 B/C; the RG-LRU cases of
     tests/test_kernels.py plus ragged lengths and the recurrentgemma-9b
     shape, forward and the backward's reverse mode, log_a down to -20
     and the slow decay of trained gates, the fused backward against
     autograd of the plain recurrence, and repeat calls bitwise equal),
     and, at the main paths' shapes, each kernel's time beside the plain
     version's, a library call's where one exists, and the card's bound
     (one call per CUDA-event pair, and back to back; the RG-LRU scan's
     reverse mode and fused backward too); one full-width mamba2 layer
     and one full-width rglru mixer through the kernel against the plain
     path;
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
  8. train: the paper's GPT, BERT and T5 (gpt-h8192-l4, bert(8192, 4)
     and t5(8192, 4): 64 heads of 128; learned positions and
     bidirectional attention for BERT; T5 with 2 bidirectional encoder
     layers and 2 decoder layers of causal self-attention and
     cross-attention over the encoder states, its encoder reading the
     decoder's tokens; random weights from seed 0) through
     `TrainSession`, sgd (lr 3e-4, no momentum), B=4 (T5 B=8), S=1024, 3
     steps on the flash kernel, kept and spooled (fs, raw). The checks of
     phase 5 with the stage count from the engine, which must be 6 (GPT,
     BERT) and 8 (T5: enc_embed, 2 encoder layers, enc_final, embed, 2
     decoder layers, head), and the flash kernel launched once per
     attention per step (the backward is the plain VJP): 4 for GPT and
     BERT, 6 for T5; the tracked activation peaks of both runs;
  9. checkpoints and tracing on the paper's GPT (gpt-h8192-l4, phase 8's
     spool settings: B=4, S=1024, sgd, fs, raw, seed 0): a traced run of
     2 steps checkpointing every 2 steps prints each step's `obs_*`
     overlap fields; its losses must be bitwise equal to phase 8's first
     two spool losses, its trace valid, with 2 `engine.step` spans, an
     `io.write` span per store and every fetch wait keyed to a read, 6
     stages fetched a step and 4 flash launches a step. Its second step
     runs under torch.profiler: the device's idle time is printed beside
     the step's exposed wait. A fresh session then restores step 2 and
     runs step 3: loss and final parameters bitwise equal to phase 8's
     third spool loss and final parameters, and its device peak equal to
     that step's (the restore writes into the session's tensors, so
     the card holds one copy of the model). The checkpoint's bytes, the
     snapshot, write and restore seconds and its filesystem are
     printed; too little free space fails the phase;
 10. storage and resilience on the paper's GPT (gpt-h8192-l4, phase 8's
     spool settings: B=4, S=1024, sgd, raw, seed 0, SpoolPolicy), traced:
     (a) `striped` over two directories, (b) `managed:2gb,fs` (a host
     bound below one step's offload), (c) `aio@8`, 2 steps each, and
     (d) the chaos run, `fault:striped` over three directories for 3
     steps with stripe device 1 killed and 3 raising reads after step 1
     (every layer's store lands before backward, so backward reads).
     Losses and final parameters must be bitwise equal to phase 8's keep
     run after as many steps, 6 stages fetched a step (in (d) fetched or
     recomputed) and 4 flash launches a step (plus one per recomputed
     layer stage), the directories empty after close; (a) writes to both
     devices at JAX's default pool idle cap and hits the pool in step 2,
     (b) demotes and is hinted without passing its host bound (its
     promotions, priced and timed as in the JAX manager, are printed),
     (c) prints whether the mount took O_DIRECT and hits the pool in
     step 2, (d) retries, falls back to recompute and rebalances, with
     device 1 down and `resilience_*` rows each step. Each run prints
     its step times, exposed wait, io_hidden_frac and pool stats; the
     copy rates between the card and a registered pool buffer at
     aligned and unaligned offsets are printed beside torch's pinned
     memory's;
 11. a `kernels` JSON line, the nvidia-smi line, and the result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
TOL_RGLRU_GRAD = 5e-4     # the JAX package's RG-LRU gradient bar
# recurrentgemma-9b's attention at head_dim 256: (B, S, Hq, Hkv, D,
# causal, window, dtype, tol); the path's shape (window 2048 masks
# nothing at S=2048), a window that masks at S=4096, and an f32 case
FLASH_D256_CASES = [
    (1, 2048, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 4096, 16, 1, 256, True, 2048, torch.bfloat16, TOL_BF16_ROW),
    (1, 512, 16, 1, 256, True, 128, torch.float32, TOL_F32),
]
RG_ARCH, RG_SEQ, RG_LR, RG_CLIP = "recurrentgemma-9b", 2048, 3e-4, 1.0
# the paper's GPT, BERT and T5 at its first scenario (§4.2): hidden 8192,
# 4 layers, S=1024, sgd without momentum; B=4 keeps the phase short (the
# paper's micro-batch of 16 runs in benchmarks/torch_fig10.py --paper).
# T5 runs at B=8: at B=4 its device peak, kept or spooled alike, is set at
# the end of backward by its parameters, its full gradients and the last
# encoder layer's backward (33.29 GB both ways on an H100 80GB HBM3 at
# 700 W), where no activation is left to spool; at B=8 its activations
# set the peak
PAPER_HIDDEN, PAPER_LAYERS, PAPER_SEQ, PAPER_BATCH = 8192, 4, 1024, 4
T5_BATCH = 8
PAPER_LR = 3e-4
# the idle cap of the spool's aligned pool in every spool run but phase
# 10's striped one (which keeps the default): three
# blobs of the largest class (a recurrentgemma-9b stage, ~1.5 GB, is in
# the 2 GiB class; a phase 8 GPT stage at B=4, ~0.85 GB, in the 1 GiB
# one), so released leases are reused, not unmapped and registered anew
POOL_BYTES = 6 << 30
# phase 10: the managed backend's host bound, below one step's offload
# (~5 GB at B=4), so blobs are demoted to the SSD tier
STORAGE_HOST_BOUND = "2gb"
# the attention of phase 8's GPT and BERT: (B, S, H, D); BERT's is
# bidirectional, GPT's causal; T5's both, at its batch (its encoder
# input has the decoder's length, so cross-attention has this shape too)
BERT_ATTN = (PAPER_BATCH, PAPER_SEQ, PAPER_HIDDEN // 128, 128)
T5_ATTN = (T5_BATCH,) + BERT_ATTN[1:]

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
    tensor cores reads `attn_fwd_mma_kernel<256>`, the RG-LRU fused
    backward's rescan `rglru_rescan_kernel<true,true>`, an SSD pass on
    bf16 B/C `ssd_states_kernel<bf16>`), then registers and spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*kernel)(?:I(\w+?)E)?E", line)
        if "Compiling entry" in line and m:
            args = re.sub(r"Lb([01])E?", lambda b: ("false,", "true,")[
                int(b.group(1))], m.group(2) or "")
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
    check (`flash_plan`, `kv_tiles`, `warp_live`, `ssd_plan`,
    `rglru_plan`) against the built libraries' own numbers: every flash
    instance's constants, the kv tiles of every q tile and the live tiles
    of every warp at the attention cases and the path shapes, the SSD
    passes at the SSD cases and the training shape, and the RG-LRU passes
    at its cases, ragged lengths and the recurrentgemma-9b shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    shapes = ATTN_CASES + [(1, S, S, 64, 64, 128, True, 0, 0.0)
                           for S in (1024, 1000)]
    shapes += [(B, S, S, H, H, D, causal, 0, 0.0) for causal in (False, True)
               for B, S, H, D in (BERT_ATTN, T5_ATTN)]
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
    for B, S, W in RGLRU_CASES + [(1, 300, 40), (2, 40, 8), (3, 129, 200),
                                  (1, RG_SEQ, 4096)]:
        mine = rg.rglru_plan(B, S, W)
        del mine["scratch"]
        check(mine == rg.library_plan(B, S, W), f"rglru_plan {mine} is not "
              f"the library's {rg.library_plan(B, S, W)}")
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


def rglru_bound_ms(x, peaks, tensors=3):
    """Least time for the RG-LRU scan: `tensors` f32 tensors of x's size
    read or written once over the memory rate (3 forward: log_a, x, h; 5
    in the backward: log_a, g, h, dx, dlog_a), or one exp and one FMA per
    element over the f32 rate (the memory side bounds it by far)."""
    nbytes = tensors * x.numel() * 4
    flops = 2 * x.numel()
    t_bytes = nbytes / peaks["bytes"]
    t_ops = flops / peaks["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scan_err(got, want, tol, scale=None):
    """(max abs error, worst error over its bar): the bar is tol (1 +
    |want|), or given a `scale`, tol (1 + scale). A slow decay's check
    gives the scale the scan has carried (`rglru_scan.scan_scale`) and
    the exact (f64) recurrence as `want`: no f32 order, the plain
    sequential one included, meets the elementwise bar there."""
    d = (got.double() - want.double()).abs()
    ref = want.double().abs() if scale is None else scale.double()
    return d.max().item(), (d / (1 + ref)).max().item() / tol


def rglru_phase(gen, peaks, smi):
    """The RG-LRU kernel against its plain version, both modes (forward,
    and the reverse recurrence) and the fused backward, and repeat calls
    bitwise equal; its times at the recurrentgemma-9b shape. Returns a
    dict of the worst error and the times."""
    from repro_torch.kernels.rglru_scan import (dlog_a_scale,
                                                rglru_scan_bwd,
                                                rglru_scan_fwd,
                                                rglru_sequential, scan_scale)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    path = (1, RG_SEQ, 4096)
    cases = [(c, "-|N(0,0.5)|")
             for c in RGLRU_CASES + [(1, 300, 40), (2, 40, 8), path]]
    cases += [(path, "U[-20,0]"), (path, "U[-1e-3,0]")]
    worst = worst_bar = 0.0

    def report(what, err, bar, tol, slow):
        how = " of the carried scale, against the f64 recurrence"
        print(f"  rglru_scan {what}: max_abs_err {err:.3e}, {bar:.3f} of the "
              f"bar (tol {tol:g}{how if slow else ''}) "
              f"{'ok' if bar <= 1 else 'FAIL'}")
        check(bar <= 1 and math.isfinite(err), f"rglru_scan {what} disagrees "
              f"with its plain version")

    for (B, S, W), decay in cases:
        if decay == "-|N(0,0.5)|":      # the JAX tests' decays
            la = -(rand((B, S, W)) * 0.5).abs()
        else:                           # uniform in [-20, 0] or [-1e-3, 0]
            depth = 20.0 if decay == "U[-20,0]" else 1e-3
            la = -torch.rand((B, S, W), generator=gen, device="cuda") * depth
        # a slow decay's oracle is the exact recurrence: the f32 sequential
        # one misses the bar there itself (printed)
        slow = decay == "U[-1e-3,0]"
        dt = torch.float64 if slow else torch.float32
        x = rand((B, S, W))
        for reverse in (False, True):
            h = rglru_scan_fwd(la, x, reverse=reverse)
            torch.cuda.synchronize()
            want = rglru_sequential(la.to(dt), x.to(dt), reverse=reverse)
            scale = scan_scale(want, reverse=reverse) if slow else None
            err, bar = scan_err(h, want, TOL_RGLRU, scale)
            worst, worst_bar = max(worst, err), max(worst_bar, bar)
            mode = "reverse" if reverse else "forward"
            report(f"B={B} S={S} W={W} log_a {decay} {mode}", err, bar,
                   TOL_RGLRU, slow)
            if slow:
                f32 = scan_err(rglru_sequential(la, x, reverse=reverse),
                               want, TOL_RGLRU, scale)
                print(f"    the plain f32 sequential {mode}: max_abs_err "
                      f"{f32[0]:.3e}, {f32[1]:.3f} of the same bar")
        if (B, S, W) != path or decay == "U[-20,0]":
            continue
        # the fused backward against autograd through the plain recurrence
        g = rand((B, S, W))
        h = rglru_scan_fwd(la, x)
        dla, dx = rglru_scan_bwd(la, g, h)
        torch.cuda.synchronize()
        la_, x_ = (t.to(dt).requires_grad_(True) for t in (la, x))
        h_ = rglru_sequential(la_, x_)
        wla, wx = torch.autograd.grad(h_, (la_, x_), g.to(dt))
        scales = ((scan_scale(wx, reverse=True), dlog_a_scale(wx, h_))
                  if slow else (None, None))
        for name, got, want, sc in (("dx", dx, wx, scales[0]),
                                    ("dlog_a", dla, wla, scales[1])):
            err, bar = scan_err(got, want, TOL_RGLRU_GRAD, sc)
            report(f"fused backward B={B} S={S} W={W} log_a {decay}: {name}",
                   err, bar, TOL_RGLRU_GRAD, slow)
        del la_, x_, h_, wla, wx, scales
        # two calls, the same bits
        for name, fn in (("forward", lambda: (rglru_scan_fwd(la, x),)),
                         ("reverse", lambda: (rglru_scan_fwd(
                             la, g, reverse=True),)),
                         ("backward", lambda: rglru_scan_bwd(la, g, h))):
            first = [t.clone() for t in fn()]
            check(all(torch.equal(a, b) for a, b in zip(first, fn())),
                  f"two rglru_scan {name} calls differ")
        print(f"  rglru_scan B={B} S={S} W={W} log_a {decay}: forward, "
              f"reverse and backward bitwise equal on a repeat call")
    la = -(rand(path) * 0.5).abs()
    x, g = rand(path), rand(path)
    h = rglru_scan_fwd(la, x)
    fns = {"forward": lambda: rglru_scan_fwd(la, x),
           "reverse": lambda: rglru_scan_fwd(la, g, reverse=True),
           "backward": lambda: rglru_scan_bwd(la, g, h)}
    out = {"max_abs_err": worst, "max_err_over_bar": worst_bar}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_ms_back_to_back"] = time_back_to_back_ms(fn)
    out["plain_ms"] = time_ms(lambda: rglru_sequential(la, x))
    out["bound"] = rglru_bound_ms(x, peaks)
    out["backward_bound"] = rglru_bound_ms(x, peaks, tensors=5)
    print(f"  rglru_scan recurrentgemma-9b shape B=1 S={RG_SEQ} W=4096 f32: "
          f"kernel_ms {out['forward_ms']:.4f} (back-to-back "
          f"{out['forward_ms_back_to_back']:.4f}), reverse "
          f"{out['reverse_ms']:.4f} ({out['reverse_ms_back_to_back']:.4f}), "
          f"fused backward {out['backward_ms']:.4f} "
          f"({out['backward_ms_back_to_back']:.4f}; bound_us "
          f"{1e3 * out['backward_bound'][0]:.1f}) plain_ms "
          f"{out['plain_ms']:.4f} library_ms none (no single PyTorch call "
          f"computes this scan) bound_us {1e3 * out['bound'][0]:.1f} "
          f"({out['bound'][1]}) on {smi}")
    return out


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


def flash_bert_phase(gen, peaks, smi):
    """The flash kernel at the attention shapes phase 8 gives it (q/k/v
    (4, 1024, 64, 128) bf16 for GPT and BERT, (8, 1024, 64, 128) for T5),
    bidirectional as BERT's (every kv tile of every query block is live)
    and causal as GPT's, against the plain attention; at each shape the
    bidirectional time beside the bound and scaled_dot_product_attention's
    (is_causal=False). Returns {"bert": ..., "t5": ...}, each a dict of
    that shape's bidirectional error and times."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
    res = {}
    for fam, (B, S, H, D) in (("t5", T5_ATTN), ("bert", BERT_ATTN)):
        q, k, v = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        for causal in (True, False):
            o = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = attention_reference(q.float(), k.float(), v.float(),
                                       causal=causal)
            err, rel, ok = attn_error(o, want, TOL_BF16_ROW)
            del o, want
            print(f"  flash_attention phase-8 shape B={B} S={S} H={H} "
                  f"D={D} causal={causal} bf16: max_abs_err {err:.3e} "
                  f"row_rel_err {rel:.3e} tol {TOL_BF16_ROW:g} of the row "
                  f"max {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention disagrees with its plain version "
                  f"at phase 8's shape B={B} (causal={causal})")
        out = res[fam] = {"max_abs_err": err, "max_row_rel_err": rel}
        out["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=False))
        out["ms_back_to_back"] = time_back_to_back_ms(
            lambda: flash_attention(q, k, v, causal=False))
        out["plain_ms"] = time_ms(lambda: attention_reference(
            q, k, v, causal=False))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out["library_ms"] = time_ms(lambda: torch.nn.functional.
                                    scaled_dot_product_attention(
                                        qt, kt, vt, is_causal=False))
        out["bound"] = bound_ms(q, k, v, False, 0, peaks)
        print(f"  phase-8 shape B={B} S={S} H={H} D={D} non-causal bf16: "
              f"kernel_ms {out['ms']:.4f} (back-to-back "
              f"{out['ms_back_to_back']:.4f}) plain_ms "
              f"{out['plain_ms']:.4f} library_ms {out['library_ms']:.4f} "
              f"(scaled_dot_product_attention, is_causal=False, yardstick "
              f"only) bound_us {1e3 * out['bound'][0]:.1f} "
              f"({out['bound'][1]}) on {smi}")
        del q, k, v, qt, kt, vt
    return res


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
              batch=1, keep_params=None, snap=None):
    """TrainSession steps at B=batch, S=seq on the card. Every kernel's
    launch count is set to 0 just before the steps and read just after.
    Returns (losses, params, reports, {kernel: launches}, run peak, stage
    count): params are the final parameters on the host, or, given the
    host parameters of an earlier run as `keep_params`, whether they are
    bitwise equal to those (one host copy of a large model, not two).
    Given a dict `snap`, its "params" get a host copy of the parameters
    after step 2 (the run goes on as one loop: `run(2)`, then `run(1)`).
    A spool run prints its pool's stats."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data.pipeline import encoder_decoder_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.session import TrainSession
    kernels = (flash_attention, ssd_scan, rglru_scan)
    loader = (encoder_decoder_batches(cfg.vocab_size, batch=batch,
                                      seq_len=seq, seed=0)
              if cfg.family == "encdec" else None)
    sess = TrainSession(cfg, policy=policy, io=io, optimizer=optimizer,
                        lr=3e-4, batch_size=batch, seq_len=seq, seed=0,
                        device="cuda", attn_impl="cuda", loader=loader)
    if hasattr(policy, "spool"):
        policy.spool = sess.spool
    try:
        sess.init()
        for k in kernels:
            k.launches = 0
        if snap is not None:
            reports = sess.run(2).reports
            snap["params"] = [t.detach().cpu()
                              for t in tree_flatten(sess.params)[0]]
            reports += sess.run(TRAIN_STEPS - 2).reports
        else:
            reports = sess.run(TRAIN_STEPS).reports
        launches = {k.__name__: k.launches for k in kernels}
        if io is not None:
            print(f"  {label} pool: {pool_line(sess.spool)}")
        n_stages = len(sess.engine.stage_names)
        leaves = tree_flatten(sess.params)[0]
        if keep_params is None:
            params = [t.detach().cpu() for t in leaves]
        else:
            params = same_params(leaves, keep_params)
        del leaves
        for r in reports:
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
        losses = [r.loss for r in reports]
        peak = max(r.extra["device_peak_bytes"] for r in reports)
    finally:
        sess.close()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    return losses, params, reports, launches, peak, n_stages


def pool_line(spool):
    """The spool's aligned pool: reuse, trims, lifetime mapping volume and
    CUDA registrations (count and seconds)."""
    p = spool.pool.stats()
    return (f"hits {p['hits']} misses {p['misses']} (hit rate "
            f"{p['hit_rate']:.3f}) trimmed {p['trimmed']} bytes_allocated "
            f"{p['bytes_allocated']} idle cap {p['idle_cap']} (set "
            f"{spool.pool.max_bytes}, peak leased {p['peak_leased_bytes']}) "
            f"CUDA registrations {p['registrations']} "
            f"({p['register_s']:.3f}s)")


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


def keep_vs_spool(cfg, seq, optimizer, want, smi, batch=1, stages=None,
                  hold=False):
    """Full-width training of `cfg` kept on the card, then spooled (fs,
    raw) to a fresh directory: bitwise losses and parameters, a lower
    peak, bytes offloaded, every stored stage fetched (the stage count
    is the engine's, and equal to `stages` where given), the directory
    empty after close, and each kernel's launches equal to `want` in
    each run. Returns the spool run's launches (the main path's); with
    `hold`, also its losses, the final parameters' host copy, each
    step's device peak and the keep run's parameters after step 2."""
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.policies import KeepPolicy, SpoolPolicy
    deterministic()
    snap = {} if hold else None
    lk, pk, rk, nk, peak_k, _ = train_run(cfg, KeepPolicy(), None,
                                          f"{cfg.name} keep",
                                          optimizer=optimizer, seq=seq,
                                          batch=batch, snap=snap)
    spool_dir = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    mnt, fstype = mount_of(spool_dir)
    ls, same, rs, ns, peak_s, n_stages = train_run(
        cfg, SpoolPolicy(), SpoolIoConfig(backend="fs", directory=spool_dir,
                                          codec="raw", pool_bytes=POOL_BYTES),
        f"{cfg.name} spool", optimizer=optimizer, seq=seq, batch=batch,
        keep_params=pk)
    n_leaves = len(pk)
    if not hold:
        del pk
    left = os.listdir(spool_dir)
    if not left:
        os.rmdir(spool_dir)
    act_k, act_s = (max(r.peak_activation_bytes for r in reps)
                    for reps in (rk, rs))
    print(f"train: {cfg.name} {cfg.num_layers + cfg.num_decoder_layers} "
          f"layers in {n_stages} "
          f"stages, d_model {cfg.d_model}, {TRAIN_STEPS} steps at B={batch} "
          f"S={seq}; keep losses {lk}, spool losses {ls}; peak device "
          f"memory keep {peak_k / 1e9:.2f} GB, spool {peak_s / 1e9:.2f} GB;"
          f" tracked activation peak keep {act_k / 1e9:.3f} GB, spool "
          f"{act_s / 1e9:.3f} GB ({100 * (1 - act_s / max(act_k, 1)):.1f}% "
          f"lower); launches keep {nk}, spool {ns}; spool dir on {mnt} "
          f"({fstype}) on {smi}")
    check(lk == ls, f"keep and spool losses differ: {lk} vs {ls}")
    check(same, "keep and spool parameters differ")
    check(peak_s < peak_k, f"spool peak {peak_s} not below keep {peak_k}")
    check(sum(r.stats.bytes_offloaded for r in rs) > 0, "nothing offloaded")
    check(all(r.extra["stages_offloaded"] == r.extra["stages_fetched"]
              == n_stages for r in rs), "a stored stage was not fetched")
    check(not left, f"spool directory not empty after close: {left[:5]}")
    check(stages is None or n_stages == stages,
          f"{n_stages} stages, want {stages}")
    for name, n in want.items():
        check(nk[name] == ns[name] == n, f"{name} launches "
              f"{nk[name]}/{ns[name]}, want {n}")
    print(f"  keep vs spool: losses and {n_leaves} parameter leaves bitwise "
          f"equal")
    return (ns, ls, pk, [r.extra["device_peak_bytes"] for r in rs],
            snap["params"]) if hold else ns


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


def paper_train_phase(smi):
    """The paper's GPT, BERT and T5 at hidden 8192, 4 layers, S=1024 with
    sgd (no momentum), at B=4 (T5 at B=8): the flash kernel once per
    attention per step, causal for GPT, bidirectional for BERT, and for
    T5 bidirectional in its 2 encoder layers, causal in the
    self-attention and bidirectional in the cross-attention of its 2
    decoder layers (the backward is the plain VJP). Stages: one per
    layer, the embed and head stages, and T5's enc_embed and enc_final.
    Returns {family: the spool run's launches} and, for phases 9 and 10,
    GPT's spool losses, final parameters (host copy), device peaks and
    the keep run's parameters after step 2."""
    from repro_torch.configs import bert, gpt, t5
    from repro_torch.optim.optimizers import sgd
    out = {}
    for fam, make in (("gpt", gpt), ("bert", bert), ("t5", t5)):
        cfg = make(PAPER_HIDDEN, PAPER_LAYERS)
        encdec = cfg.family == "encdec"
        # each decoder layer of T5 attends twice: to itself, then to enc
        per_step = cfg.num_layers + 2 * cfg.num_decoder_layers
        out[fam] = keep_vs_spool(
            cfg, PAPER_SEQ, sgd(PAPER_LR),
            {"flash_attention": per_step * TRAIN_STEPS, "ssd_scan": 0,
             "rglru_scan": 0}, smi,
            batch=T5_BATCH if encdec else PAPER_BATCH,
            stages=PAPER_LAYERS + 2 + 2 * encdec, hold=fam == "gpt")
    out["gpt"], *gpt_run = out["gpt"]
    return out, gpt_run


def device_busy_s(prof_trace):
    """(kernel busy, copy busy) seconds: the union of the card's kernel
    intervals and of its memory copies in an exported torch.profiler
    trace (None, None if it holds no device event)."""
    with open(prof_trace) as f:
        events = json.load(f).get("traceEvents", [])

    def busy(cats):
        ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in cats and e.get("ph") == "X")
        total, end = 0.0, -math.inf
        for lo, hi in ivs:
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        return total / 1e6, len(ivs)

    kernels, n = busy(("kernel",))
    copies, _ = busy(("gpu_memcpy", "gpu_memset"))
    return (kernels, copies) if n else (None, None)


def ckpt_trace_phase(smi, spool_losses, final_params, spool_peaks):
    """Phase 9: checkpoints and tracing on the paper's GPT at phase 8's
    spool settings. A traced run of 2 steps (checkpoints every 2 steps,
    its second step under torch.profiler), then a fresh session that
    restores step 2 and runs step 3; held bitwise against phase 8's spool
    run (`spool_losses`, `final_params`: its final parameters on the
    host), and its device peak against that run's third step's
    (`spool_peaks`): the restore leaves one copy of the model on the
    card. Returns the flash launches of the two runs."""
    from repro_torch.configs import SpoolIoConfig, gpt
    from repro_torch.core.policies import SpoolPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.obs.export import validate_trace
    from repro_torch.optim.optimizers import sgd
    from repro_torch.session import TrainSession
    from torch.profiler import ProfilerActivity, profile
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    deterministic()
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt, trace = os.path.join(work, "ckpt"), os.path.join(work, "t.json")
    prof_trace = os.path.join(work, "profile.json")
    ckpt_bytes = sum(t.numel() * t.element_size() for t in final_params)
    mnt, fstype = mount_of(work)
    free = shutil.disk_usage(work).free
    # a step rewritten in place holds two copies until the commit, beside
    # a few GB of spooled activations
    need = 2 * ckpt_bytes + 10e9
    print(f"ckpt: directory on {mnt} ({fstype}), {free / 1e9:.1f} GB free, "
          f"a checkpoint is {ckpt_bytes / 1e9:.2f} GB")
    check(free >= need, f"ckpt: {free / 1e9:.1f} GB free under {work}, "
          f"need {need / 1e9:.1f} GB for phase 9")

    def session(name, **kw):
        return TrainSession(
            cfg, policy=SpoolPolicy(), io=SpoolIoConfig(
                backend="fs", directory=os.path.join(work, name),
                codec="raw", pool_bytes=POOL_BYTES),
            optimizer=sgd(PAPER_LR), lr=PAPER_LR,
            batch_size=PAPER_BATCH, seq_len=PAPER_SEQ, seed=0,
            device="cuda", attn_impl="cuda", ckpt_dir=ckpt, keep_last=1,
            **kw)

    obs_keys = ("io_busy_s", "exposed_wait_s", "io_hidden_frac",
                "stall_read_s", "stall_decode_s", "stall_queue_s",
                "store_s", "load_s", "encode_s", "decode_s",
                "prefetch_hit_rate")
    try:
        sess = session("spool_traced", ckpt_every=2, trace=trace)
        prof = profile(activities=[ProfilerActivity.CUDA])
        window = {}

        def on_report(rep):
            # the profiler covers step 2 alone: on from step 1's report
            # to step 2's, before step 2's checkpoint
            if rep.step == 1:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            else:
                torch.cuda.synchronize()
                window["s"] = time.perf_counter() - window["t0"]
                prof.stop()

        try:
            sess.init()
            flash_attention.launches = 0
            reports = sess.run(2, on_report=on_report).reports
            traced_launches = flash_attention.launches
            ck = sess.ckpt
            snap_s, write_s = ck.last_snapshot_s, ck.last_write_s
        finally:
            sess.close()
        num_stores = sess.spool.stats.num_stores
        print(f"  traced run pool: {pool_line(sess.spool)}")
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        losses = [r.loss for r in reports]
        for r in reports:
            print(f"  traced step {r.step}: loss {r.loss:.6f} "
                  f"{r.step_time:.3f}s fetched {r.extra['stages_fetched']} "
                  f"stages; obs " + " ".join(f"{k} {r.obs[k]:.4f}"
                                             for k in obs_keys))
        prof.export_chrome_trace(prof_trace)
        kernel_s, copy_s = device_busy_s(prof_trace)
        r2 = reports[1]
        if kernel_s is None:
            print("  step 2 under torch.profiler: no device event seen; "
                  "device idle not measured")
        else:
            idle = window["s"] - kernel_s
            print(f"  step 2 under torch.profiler: step {r2.step_time:.3f}s, "
                  f"profiled window {window['s']:.3f}s, kernels busy "
                  f"{kernel_s:.3f}s, copies busy {copy_s:.3f}s, device idle "
                  f"(no kernel) {idle:.3f}s; exposed wait "
                  f"{r2.obs['exposed_wait_s']:.3f}s; idle minus exposed "
                  f"wait {idle - r2.obs['exposed_wait_s']:.3f}s on {smi}")
        errors = validate_trace(trace, ("engine", "spool", "io", "codec"))
        check(not errors, f"ckpt: trace invalid: {errors[:3]}")
        with open(trace) as f:
            host = [e for e in json.load(f)["traceEvents"]
                    if e["pid"] == 0]
        names = [e["name"] for e in host]
        reads = {e["args"]["key"] for e in host if e["name"] == "io.read"}
        waits = [e["args"]["key"] for e in host
                 if e["name"] == "spool.fetch_wait"]
        print(f"  trace: {len(host)} host events, {names.count('io.write')} "
              f"io.write for {num_stores} stores, {len(waits)} fetch waits, "
              f"{names.count('io.read')} reads; flash launches "
              f"{traced_launches}")
        check(losses == spool_losses[:2], f"ckpt: traced losses {losses} "
              f"differ from phase 8's spool losses {spool_losses[:2]}")
        check(names.count("engine.step") == 2, "ckpt: engine.step spans "
              f"{names.count('engine.step')}, want 2")
        check(names.count("io.write") == num_stores > 0,
              f"ckpt: {names.count('io.write')} io.write spans for "
              f"{num_stores} stores")
        check(all(r.extra["stages_fetched"] == PAPER_LAYERS + 2
                  for r in reports), "ckpt: a stage was not fetched")
        check(all(k in reads for k in waits),
              "ckpt: a fetch wait has no read of its key")
        check(traced_launches == 4 * 2, f"ckpt: {traced_launches} flash "
              f"launches in 2 traced steps, want 8")
        npz = os.path.join(ckpt, "step_00000002", "arrays.npz")
        check(os.path.exists(npz), "ckpt: no committed step 2")
        npz_bytes = os.path.getsize(npz)

        # resume: a fresh session restores step 2 and runs step 3
        sess = session("spool_resumed")
        try:
            sess.init()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            rep3 = sess.run(1, resume=True).reports[0]
            run_s = time.perf_counter() - t0
            resumed_launches = flash_attention.launches
            restore_s = sess.ckpt.last_restore_s
            leaves = tree_flatten(sess.params)[0]
            same = same_params(leaves, final_params)
            del leaves
        finally:
            sess.close()
            del sess
            gc.collect()
            torch.cuda.empty_cache()
        peak3 = rep3.extra["device_peak_bytes"]
        print(f"  resumed at step 2: step {rep3.step} loss {rep3.loss:.6f} "
              f"({rep3.step_time:.3f}s; restore {restore_s:.3f}s, the "
              f"run with its final checkpoint {run_s:.3f}s); flash "
              f"launches {resumed_launches}; device peak {peak3} bytes, "
              f"phase 8's spool steps {spool_peaks} bytes")
        print(f"ckpt: gpt-h8192-l4 arrays.npz {npz_bytes} bytes "
              f"({npz_bytes / 1e9:.3f} GB); host snapshot {snap_s:.3f}s, "
              f"async write {write_s:.3f}s (the final save at step 2), "
              f"restore {restore_s:.3f}s; on {mnt} ({fstype}), "
              f"{shutil.disk_usage(work).free / 1e9:.1f} GB free; {smi}")
        check(rep3.step == 3 and rep3.loss == spool_losses[2],
              f"ckpt: resumed step {rep3.step} loss {rep3.loss}, phase 8 "
              f"gave {spool_losses[2]}")
        check(same, "ckpt: resumed final parameters differ from phase 8's")
        check(resumed_launches == 4, f"ckpt: {resumed_launches} flash "
              f"launches in the resumed step, want 4")
        check(peak3 == spool_peaks[2], f"ckpt: the resumed step's device "
              f"peak {peak3} differs from phase 8's third step's "
              f"{spool_peaks[2]}")
        check(os.listdir(ckpt) == ["step_00000003"],
              f"ckpt: keep_last=1 left {os.listdir(ckpt)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("  checkpoints and tracing: traced losses, the resumed step and "
          "the final parameters bitwise equal to phase 8")
    return traced_launches, resumed_launches


def copy_rates(smi, nbytes=1 << 30):
    """Host-to-device and device-to-host rates (GB/s, best of 3, CUDA
    events) from a buffer the spool's pool registered with CUDA, at
    offsets 0, 1, 8 and 4096 of it (a blob's leaves sit at offsets the
    variable-length header sets, not aligned ones), beside torch's own
    pinned memory."""
    from repro_torch.io.bufpool import AlignedBufferPool
    pool = AlignedBufferPool(max_bytes=0)
    pool.register_cuda()
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def rate(host, to_device):
        best = math.inf
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            if to_device:
                dev.copy_(host, non_blocking=True)
            else:
                host.copy_(dev, non_blocking=True)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return nbytes / best / 1e9

    out = {}
    with pool.acquire(nbytes + 4096) as lease:
        for off in (0, 1, 8, 4096):
            host = torch.frombuffer(lease.mv[off:off + nbytes],
                                    dtype=torch.uint8)
            out[off] = (rate(host, True), rate(host, False))
            del host
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out["torch pinned"] = (rate(pinned, True), rate(pinned, False))
    del pinned, dev
    pool.close()
    print("  copy rates from a registered pool lease, H2D / D2H GB/s: "
          + "; ".join(f"offset {k}: {a:.2f} / {b:.2f}" if k != "torch pinned"
                      else f"{k}: {a:.2f} / {b:.2f}" for k, (a, b)
                      in out.items()) + f" (1 GiB, best of 3) on {smi}")
    return out


def storage_phase(smi, keep_losses, params2, params3):
    """Phase 10: the storage stack and resilience on the paper's GPT at
    phase 8's spool settings, traced: striped, managed, aio (2 steps
    each) and the chaos run (3 steps), each held bitwise against phase
    8's keep run (`keep_losses`; `params2` / `params3`: its parameters
    after steps 2 and 3, on the host). Returns the flash launches of the
    four runs."""
    from repro_torch import obs
    from repro_torch.configs import SpoolIoConfig, gpt
    from repro_torch.core.policies import SpoolPolicy
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.optim.optimizers import sgd
    from repro_torch.resilience import ChaosHarness, unwrap_chain
    from repro_torch.session import TrainSession
    cfg = gpt(PAPER_HIDDEN, PAPER_LAYERS)
    n_stages = PAPER_LAYERS + 2
    deterministic()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_storage_")

    def dirs(*names):
        return ",".join(os.path.join(work, n) for n in names)

    runs = [("striped", f"striped:{dirs('s0', 's1')}", 2),
            ("managed", f"managed:{STORAGE_HOST_BOUND},fs:{dirs('ssd')}", 2),
            ("aio", f"aio:{dirs('aio')}@8", 2),
            ("chaos", f"fault:striped:{dirs('c0', 'c1', 'c2')}", 3)]
    mnt, fstype = mount_of(work)
    print(f"storage: gpt-h8192-l4 B={PAPER_BATCH} S={PAPER_SEQ} sgd raw, "
          f"directories on {mnt} ({fstype}), pool idle cap {POOL_BYTES} "
          f"bytes, on {smi}")
    copy_rates(smi)
    launches = {}
    try:
        for label, spec, steps in runs:
            chaos = label == "chaos"
            policy = drained_spool_policy() if chaos else SpoolPolicy()
            # the striped run keeps the default idle cap (a registered
            # pool raises it to the most bytes it had leased at once)
            io = SpoolIoConfig(backend=spec, codec="raw",
                               pool_bytes=(SpoolIoConfig.pool_bytes
                                           if label == "striped"
                                           else POOL_BYTES),
                               retry_attempts=2 if chaos else 3,
                               retry_backoff_s=1e-3 if chaos else 0.01)
            sess = TrainSession(
                cfg, policy=policy, io=io, optimizer=sgd(PAPER_LR),
                lr=PAPER_LR, batch_size=PAPER_BATCH, seq_len=PAPER_SEQ,
                seed=0, device="cuda", attn_impl="cuda",
                trace_ring=obs.DEFAULT_RING_SIZE)
            policy.spool = sess.spool
            pools = []
            try:
                sess.init()
                flash_attention.launches = 0

                def on_report(rep):
                    pools.append(dict(sess.spool.pool.stats()))

                reports = sess.run(1, on_report=on_report).reports
                harness = ChaosHarness(sess.spool.backend)
                if chaos:
                    sess.spool.wait_io()
                    harness.kill_device(1)
                    harness.raising_reads(3)
                reports += sess.run(steps - 1, on_report=on_report).reports
                launches[label] = flash_attention.launches
                events, _ = obs.get_tracer().snapshot_new(None)
                fallbacks = [e[4]["stage"] for e in events
                             if e[0] == "resilience.fetch_fallback"]
                leaves = tree_flatten(sess.params)[0]
                same = same_params(leaves, params3 if steps == 3
                                   else params2)
                del leaves
                report = harness.report()
                st = sess.spool.stats
                chain = list(unwrap_chain(sess.spool.backend))
                extra = []
                for b in chain:
                    if hasattr(b, "per_device_write_bytes"):
                        extra.append(f"per-device write bytes "
                                     f"{b.per_device_write_bytes()}")
                    if hasattr(b, "direct"):
                        amnt, afs = mount_of(b.directory)
                        extra.append(
                            f"aio on {amnt} ({afs}): "
                            + ("O_DIRECT accepted" if b.direct else
                               "O_DIRECT refused, buffered + fdatasync "
                               "+ fadvise"))
                    if hasattr(b, "residency"):
                        lo, up = b.lower.stats, b.upper.stats
                        extra.append(
                            f"host peak {b.peak_host_bytes} of bound "
                            f"{b.capacity_bytes}; GB/s read / write: SSD "
                            f"tier {lo.read_bandwidth / 1e9:.2f} / "
                            f"{lo.write_bandwidth / 1e9:.2f}, host tier "
                            f"{up.read_bandwidth / 1e9:.2f} / "
                            f"{up.write_bandwidth / 1e9:.2f}")
                sess.spool.wait_io()
                pool = pool_line(sess.spool)
                striped = next((b for b in chain
                                if hasattr(b, "per_device_write_bytes")),
                               None)
                dev_bytes = (striped.per_device_write_bytes()
                             if striped is not None else [])
                aio_direct = next((b.direct for b in chain
                                   if hasattr(b, "direct")), None)
            finally:
                sess.close()
                del sess
                gc.collect()
                torch.cuda.empty_cache()
            losses = [r.loss for r in reports]
            rows = [r.to_metrics() for r in reports]
            for r, row, p in zip(reports, rows, pools):
                cache = {k[6:]: v for k, v in row.items()
                         if k.startswith("cache_")}
                resil = {k[11:]: v for k, v in row.items()
                         if k.startswith("resilience_")}
                print(f"  {label} step {r.step}: loss {r.loss:.6f} "
                      f"{r.step_time:.3f}s fetch wait "
                      f"{r.stats.fetch_wait_time:.3f}s exposed wait "
                      f"{r.obs['exposed_wait_s']:.3f}s io_hidden_frac "
                      f"{r.obs['io_hidden_frac']:.4f} fetched "
                      f"{r.extra['stages_fetched']} stages; pool hits "
                      f"{p['hits']} misses {p['misses']} trimmed "
                      f"{p['trimmed']} bytes_allocated "
                      f"{p['bytes_allocated']}; resilience {resil}"
                      + (f"; cache {cache}" if cache else ""))
            print(f"  {label}: {spec.split(':')[0]} losses {losses}, "
                  f"flash launches {launches[label]}, stores "
                  f"{st.num_stores} loads {st.num_loads} store retries "
                  f"{st.store_retries} load retries {st.load_retries} "
                  f"fallbacks {st.fetch_fallbacks} {fallbacks}; "
                  f"{'; '.join(extra)}; pool {pool}"
                  + (f"; chaos report {report}" if chaos else ""))
            left = [f for _, _, fs in os.walk(work) for f in fs]
            check(losses == keep_losses[:steps],
                  f"storage {label}: losses {losses} differ from keep's "
                  f"{keep_losses[:steps]}")
            check(same, f"storage {label}: parameters differ from keep's "
                  f"after {steps} steps")
            check(not left, f"storage {label}: files left after close: "
                  f"{left[:5]}")
            layer_fallbacks = sum(name.startswith("seg")
                                  for name in fallbacks)
            check(launches[label] == 4 * steps + layer_fallbacks,
                  f"storage {label}: {launches[label]} flash launches "
                  f"for {steps} steps and {layer_fallbacks} recomputed "
                  f"layer stages")
            check(all(r.extra["stages_fetched"]
                      + row["resilience_fetch_fallbacks"] == n_stages
                      for r, row in zip(reports, rows)),
                  f"storage {label}: a stage was neither fetched nor "
                  f"recomputed")
            check(all("resilience_health" in row for row in rows),
                  f"storage {label}: a row without its resilience block")
            if label == "striped":
                check(len(dev_bytes) == 2 and min(dev_bytes) > 0,
                      f"storage striped: per-device bytes {dev_bytes}")
                check(len(pools) == 2 and pools[1]["hits"]
                      > pools[0]["hits"], "storage striped: no pool hit "
                      "in step 2 at the default idle cap")
            if label == "managed":
                # promotions are priced by measured rates (the SSD tier's
                # read against the host tier's write) and race the load
                # of the same key, as in the JAX manager: printed, not
                # required
                check(sum(row["cache_evictions"] for row in rows) > 0
                      and sum(row["cache_hints"] for row in rows) > 0,
                      "storage managed: no demotion or no reuse hint")
                check(all(row["cache_host_peak_bytes"]
                          <= row["cache_host_bound_bytes"] for row in rows),
                      "storage managed: the host bound was passed")
            if label == "aio":
                check(aio_direct is not None, "storage aio: no aio backend")
                check(len(pools) == 2 and pools[1]["hits"]
                      > pools[0]["hits"], "storage aio: no pool hit in "
                      "step 2")
            if chaos:
                check(st.load_retries > 0 and st.fetch_fallbacks > 0,
                      f"storage chaos: load retries {st.load_retries}, "
                      f"fallbacks {st.fetch_fallbacks}")
                check(report["rebalanced_chunks"] > 0
                      and report["devices_down"] == 1,
                      f"storage chaos: report {report}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"  storage and resilience: 4 runs bitwise equal to keep in "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def adaptive_check(label, policy, reps):
    """The adaptive plan against the paper's rule (§3.3.3), worked here
    from the profiled stages and the calibrated write rate: offloading
    stages 0..m needs (bytes of 0..m-1 + 2 x bytes of m) / (forward time
    of 1..m + (1 + bwd_factor) x forward time of m+1..) within the rate,
    and the plan takes the largest such m short of the last stage. The
    profiling step offloads every stage and reads blobs back. A planned
    step reads blobs back where it stores bytes, and it does store bytes
    where its plan holds a layer stage (the embed stage's saved token ids
    fall under the spool's size filter). The write rate is the
    calibrated tiers' rate for the plan's bytes, scaled as the policy
    scales it after a health event of the backend (a re-plan)."""
    from repro_torch.core.adaptive import effective_write_bandwidth
    prof, bw, plan = policy.profiles, policy.bandwidths, policy.plan
    nbytes = [p.bytes for p in prof]
    fwd = [p.fwd_time for p in prof]
    ev = policy.last_health_event
    scale = (1.0 if ev is None or ev.kind == "recovered" else
             0.0 if ev.kind == "failing" else 1 / max(ev.latency_ratio, 1))

    def plan_bytes(m):
        return sum(nbytes[:m]) + 2 * nbytes[m]

    def rate(m):
        r = (bw if isinstance(bw, (int, float)) else
             effective_write_bandwidth(bw, plan_bytes(m)))
        return r * scale

    def need(m):
        deadline = sum(fwd[1:m + 1]) + (1 + policy.bwd_factor) * sum(
            fwd[m + 1:])
        return plan_bytes(m) / deadline if deadline > 0 else float("inf")

    want = max((m for m in range(len(prof) - 1) if need(m) <= rate(m)),
               default=-1)
    m = plan.last_offloaded
    tiers = ("" if isinstance(bw, (int, float)) else " (tiers " + ", ".join(
        f"{t.name} {t.write_bw / 1e9:.3f} GB/s" for t in bw) + ")")
    print(f"  d{MATRIX_DEPTH} {label}: calibrated write rate "
          f"{rate(max(m, 0)) / 1e9:.3f} GB/s{tiers}, {policy.replans} "
          f"re-plans on health events (scale {scale:.3f}), profiled "
          f"forward {sum(fwd):.4f} s over "
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
    from repro_torch.kernels.rglru_scan import \
        KERNELS_PER_CALL as RG_KERNELS_PER_CALL
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
            if line.startswith(("attn_fwd_mma_kernel", "rglru_")):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"a tensor-core flash or RG-LRU instance spills: "
                      f"{line}")
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
    rg = rglru_phase(gen, peaks, smi)
    d256 = flash_d256_phase(gen, peaks, smi)
    paper_attn = flash_bert_phase(gen, peaks, smi)
    bert_attn = paper_attn["bert"]
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
    t2 = time.perf_counter()

    # ---- 8. train the paper's GPT, BERT and T5 at hidden 8192, keep vs
    # spool
    paper_launches, (gpt_losses, gpt_params, gpt_peaks, gpt_params2) = \
        paper_train_phase(smi)
    t3 = time.perf_counter()

    # ---- 9. checkpoints and tracing on the paper's GPT
    ckpt_launches = ckpt_trace_phase(smi, gpt_losses, gpt_params, gpt_peaks)
    t4 = time.perf_counter()

    # ---- 10. storage and resilience on the paper's GPT (phase 8's keep
    # and spool losses are bitwise equal)
    storage_launches = storage_phase(smi, gpt_losses, gpt_params2,
                                     gpt_params)
    del gpt_params, gpt_params2
    print(f"train phases: mamba2 {t1 - t0:.1f}s, recurrentgemma "
          f"{t2 - t1:.1f}s, GPT, BERT and T5 {t3 - t2:.1f}s, checkpoints "
          f"and tracing {t4 - t3:.1f}s, storage and resilience "
          f"{time.perf_counter() - t4:.1f}s")

    # ---- 11. result
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
        # the paper's GPT, BERT and T5 training (phase 8), and BERT's
        # bidirectional attention shape
        "launches_per_gpt_train_run": paper_launches["gpt"][
            "flash_attention"],
        "launches_per_bert_train_run": paper_launches["bert"][
            "flash_attention"],
        "launches_per_t5_train_run": paper_launches["t5"][
            "flash_attention"],
        # phase 9: the traced 2-step GPT run and the resumed step
        "launches_per_traced_gpt_run": ckpt_launches[0],
        "launches_per_resumed_gpt_step": ckpt_launches[1],
        # phase 10: the striped, managed, aio and chaos runs
        "launches_per_storage_run": storage_launches,
        "noncausal_max_abs_err": bert_attn["max_abs_err"],
        "noncausal_max_row_rel_err": bert_attn["max_row_rel_err"],
        "noncausal_ms": bert_attn["ms"],
        "noncausal_ms_back_to_back": bert_attn["ms_back_to_back"],
        "noncausal_plain_ms": bert_attn["plain_ms"],
        "noncausal_library_ms": bert_attn["library_ms"],
        "noncausal_bound_ms": bert_attn["bound"][0],
        "noncausal_bound_by": bert_attn["bound"][1],
        # T5's attention shape in phase 8 (B=8), bidirectional
        "t5_noncausal_max_row_rel_err": paper_attn["t5"]["max_row_rel_err"],
        "t5_noncausal_ms": paper_attn["t5"]["ms"],
        "t5_noncausal_ms_back_to_back": paper_attn["t5"]["ms_back_to_back"],
        "t5_noncausal_plain_ms": paper_attn["t5"]["plain_ms"],
        "t5_noncausal_library_ms": paper_attn["t5"]["library_ms"],
        "t5_noncausal_bound_ms": paper_attn["t5"]["bound"][0],
        "t5_noncausal_bound_by": paper_attn["t5"]["bound"][1],
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
        # wrapper calls: one forward and one fused backward per rglru
        # block per step
        "launches": rg_launches["rglru_scan"],
        "launches_per_train_run": rg_launches["rglru_scan"],
        "max_abs_err": rg["max_abs_err"],
        "max_err": rg["max_abs_err"],
        "max_err_over_bar": rg["max_err_over_bar"],
        "tol": TOL_RGLRU,
        "ms": rg["forward_ms"],
        "kernel_ms": rg["forward_ms"],
        "ms_back_to_back": rg["forward_ms_back_to_back"],
        "plain_ms": rg["plain_ms"],
        "bound_ms": rg["bound"][0],
        "bound_us": 1e3 * rg["bound"][0],
        "bound_by": rg["bound"][1],
        "library_ms": None,
        "redesigned": 15,
        "ms_over_library_ms": None,
        "bound_over_ms": rg["bound"][0] / rg["forward_ms"],
        "kernels_per_call": RG_KERNELS_PER_CALL,
        "reverse_ms": rg["reverse_ms"],
        "reverse_ms_back_to_back": rg["reverse_ms_back_to_back"],
        "backward_ms": rg["backward_ms"],
        "backward_ms_back_to_back": rg["backward_ms_back_to_back"],
        "backward_bound_ms": rg["backward_bound"][0],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
