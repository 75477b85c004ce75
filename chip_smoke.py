#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, one nvcc per source at once;
  3. kernels: each kernel against its plain PyTorch version on the card
     (the flash-attention cases of tests/test_kernels.py plus the serve
     prefill shapes), and, at the serve shape, the kernel's time beside
     the plain version's, a library call's and the card's bound;
  4. serve: the paper's GPT (gpt-h8192-l4, random weights from seed 0)
     through `repro_torch.launch.serve`, paged KV with quantum
     preemption evicting pages through the spool to a directory, then
     the same trace on the dense cache. Tokens and every logits row
     must be bitwise equal, every evicted page restored, the spool
     directory empty after close, and the kernel launched once per
     layer per prefill in the paged run;
  5. a `kernels` JSON line, the nvidia-smi line, and the result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
TOL_F32, TOL_BF16 = 2e-5, 3e-2
# full-width prefill logits, kernel vs plain attention path: both bf16
# models, so they differ by bf16 roundings of the attention output that
# propagate through 4 layers (4 bf16 ulps at |logit| ~ 8)
TOL_E2E = 0.25

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
    """Median over `runs` of one call timed with CUDA events."""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference
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
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # ---- 3. kernel vs plain version
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [(c, torch.float32, TOL_F32) for c in ATTN_CASES]
    cases.append(((2, 64, 64, 4, 2, 32, True, 0, 0.0), torch.bfloat16,
                  TOL_BF16))
    cases += [((1, S, S, 64, 64, 128, True, 0, 0.0), torch.bfloat16,
               TOL_BF16) for S in (1024, 1000)]
    worst = 0.0
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
        err = (out.float() - want).abs().max().item()
        ok = bool(torch.all((out.float() - want).abs()
                            <= tol + tol * want.abs()))
        print(f"  flash_attention B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} "
              f"D={D} causal={causal} window={window} cap={cap} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} tol {tol:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), "flash_attention disagrees with "
              "its plain version")
        if tol == TOL_BF16:
            worst = max(worst, err)
        if Sq == 1024:
            serve_inputs = (q, k, v)
    q, k, v = serve_inputs
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))
    b_ms, b_by = bound_ms(q, k, v, True, 0, peaks)
    print(f"  serve shape B=1 S=1024 H=64 D=128 causal bf16: kernel_ms "
          f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} (scaled_dot_product_attention, yardstick only) "
          f"bound_us {1e3 * b_ms:.1f} ({b_by}) on {smi}")

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

    # ---- 5. result
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
        "tol": TOL_BF16,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_us": 1e3 * b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
