#!/usr/bin/env python3
"""Time the port's flash-attention forward and SSD scan against those of
an earlier commit, in one process on one card, in turns (old, new, new,
old), at the main paths' shapes.

    mkdir -p _local/old
    git archive <commit> src/repro_torch | tar -x -C _local/old
    python3 kernel_ab.py --old _local/old [--out ab.json]

The earlier tree's `repro_torch` is imported as module objects of its
own and builds its libraries from its own sources (into its own
`_build/`); both versions are called through their public wrappers
(`flash_attention`, `ssd_scan_fwd`). Times are `chip_smoke.time_ms`
(one call per CUDA-event pair) and `chip_smoke.time_back_to_back_ms`,
never mixed, and each side's CUDA kernels' device time comes from
torch.profiler. Old and new must agree with each other within twice
`chip_smoke.py`'s bars first. Prints one line per shape with the card's
nvidia-smi line, and one JSON object as the last line.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


def _ours():
    return {k: m for k, m in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}


def import_old(old_root):
    """(flash_attention module, ssd_scan module) of the tree at
    `old_root`, its libraries built; the current tree's modules stay
    what `repro_torch` names."""
    saved = _ours()
    for k in saved:
        del sys.modules[k]
    path = os.path.join(os.path.abspath(old_root), "src")
    sys.path.insert(0, path)
    try:
        old_build = importlib.import_module("repro_torch.kernels.build")
        old_fa = importlib.import_module("repro_torch.kernels.flash_attention")
        old_ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
        for name in old_build.build_all():
            for line in cs.ptxas_report(old_build.build_log(name)):
                print(f"  ptxas old {name}: {line}")
    finally:
        sys.path.remove(path)
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return old_fa, old_ssd


def device_times_us(fn, n=10):
    """Device time per call of each CUDA kernel `fn` launches, from
    torch.profiler, in microseconds ({} if it sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t and "kernel" in e.key:
            out[e.key[:60]] = t / n
    return out


def path_cases(old_fa, old_ssd, gen):
    """(name, old call, new call, library call or None, bar relative to
    the output's scale, the inputs) at the serve prefill,
    recurrentgemma-9b's attention and mamba2-2.7b's scan."""
    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bf = torch.bfloat16
    for name, qs, kvs, window in (
            ("flash_serve", (1, 1024, 64, 128), (1, 1024, 64, 128), 0),
            ("flash_d256", (1, 2048, 16, 256), (1, 2048, 1, 256), 2048)):
        q = rand(qs, bf)
        k, v = rand(kvs, bf), rand(kvs, bf)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        yield (name,
               lambda f=old_fa, q=q, k=k, v=v, w=window: f.flash_attention(
                   q, k, v, causal=True, window=w),
               lambda q=q, k=k, v=v, w=window: fa.flash_attention(
                   q, k, v, causal=True, window=w),
               lambda qt=qt, kt=kt, vt=vt: torch.nn.functional.
               scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True,
                   enable_gqa=qt.shape[1] != kt.shape[1]),
               2 * cs.TOL_BF16_ROW, (q, k, v, window))
    conv = rand((1, 1024, 5376), bf)
    Bs, Cs = conv[..., 5120:5248], conv[..., 5248:]
    xh = rand((1, 1024, 80, 64))
    a = -torch.nn.functional.softplus(rand((1, 1024, 80)))
    yield ("ssd", lambda: old_ssd.ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)[0],
           lambda: ssd.ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)[0], None,
           2 * cs.TOL_SSD_PATH, (xh, a, Bs, Cs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="root of the earlier tree (holding src/repro_torch)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = cs.peaks_for(smi)
    for name in build.build_all():
        for line in cs.ptxas_report(build.build_log(name)):
            print(f"  ptxas new {name}: {line}")
    old_fa, old_ssd = import_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, bad = {"device": smi}, []
    for name, old_fn, new_fn, lib_fn, tol, ins in path_cases(old_fa, old_ssd,
                                                             gen):
        want = old_fn().float()
        err = (new_fn().float() - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= tol * scale
        print(f"  {name}: old vs new max_abs_err {err:.3e} (output scale "
              f"{scale:.2f}, bar {tol:g} of it) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
        fns = (old_fn, new_fn, new_fn, old_fn)
        one = [cs.time_ms(f) for f in fns]
        b2b = [cs.time_back_to_back_ms(f) for f in fns]
        r = {"old_ms": [one[0], one[3]], "new_ms": [one[1], one[2]],
             "old_back_to_back_ms": [b2b[0], b2b[3]],
             "new_back_to_back_ms": [b2b[1], b2b[2]],
             "old_device_us": device_times_us(old_fn),
             "new_device_us": device_times_us(new_fn),
             "library_ms": None, "library_back_to_back_ms": None}
        if lib_fn is not None:
            r["library_ms"] = cs.time_ms(lib_fn)
            r["library_back_to_back_ms"] = cs.time_back_to_back_ms(lib_fn)
            q, k, v, window = ins
            r["bound_ms"] = cs.bound_ms(q, k, v, True, window, peaks)[0]
        else:
            r["bound_ms"] = cs.ssd_bound_ms(*ins, 128, peaks)[0]
        r["new_over_old"] = max(one[1], one[2]) / min(one[0], one[3])
        r["new_over_old_back_to_back"] = (max(b2b[1], b2b[2])
                                          / min(b2b[0], b2b[3]))
        res[name] = r
        print(f"{name}: one call old {r['old_ms']} new {r['new_ms']} "
              f"(new/old {r['new_over_old']:.4f}); back to back old "
              f"{r['old_back_to_back_ms']} new {r['new_back_to_back_ms']} "
              f"(new/old {r['new_over_old_back_to_back']:.4f}); library "
              f"{r['library_ms']} / {r['library_back_to_back_ms']}; bound_us "
              f"{1e3 * r['bound_ms']:.1f}; device us old "
              f"{r['old_device_us']} new {r['new_device_us']} on {smi}")
    res["failures"] = bad
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
