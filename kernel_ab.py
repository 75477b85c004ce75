#!/usr/bin/env python3
"""Time the port's flash-attention forward, SSD scan and RG-LRU scan
against those of an earlier commit, in one process on one card, in
turns (old, new, new, old), at the main paths' shapes.

    mkdir -p _local/old
    git archive <commit> src/repro_torch | tar -x -C _local/old
    python3 kernel_ab.py --old _local/old [--out ab.json]

The earlier tree's `repro_torch` is imported as module objects of its
own and builds its libraries from its own sources (into its own
`_build/`); both versions are called through their public wrappers
(`flash_attention`, `ssd_scan_fwd`, `rglru_scan_fwd`, and the RG-LRU
backward as autograd runs it: `torch.autograd.grad` through
`rglru_scan`). Times are `chip_smoke.time_ms` (one call per CUDA-event
pair) and `chip_smoke.time_back_to_back_ms`, never mixed, and each
side's CUDA kernels' device time comes from torch.profiler. Old and new
must agree with each other within twice `chip_smoke.py`'s bars first.
Prints one line per shape with the card's nvidia-smi line, and one JSON
object as the last line.
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
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


def _ours():
    return {k: m for k, m in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}


def import_old(old_root):
    """(flash_attention, ssd_scan, rglru_scan modules) of the tree at
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
        old_rg = importlib.import_module("repro_torch.kernels.rglru_scan")
        for name in old_build.build_all():
            for line in cs.ptxas_report(old_build.build_log(name)):
                print(f"  ptxas old {name}: {line}")
    finally:
        sys.path.remove(path)
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return old_fa, old_ssd, old_rg


def device_times_us(fn, n=10):
    """Device time per call of each CUDA kernel `fn` launches (summed
    over kernels whose names share their first 60 characters), from
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
            out[e.key[:60]] = out.get(e.key[:60], 0.0) + t / n
    return out


def scale_agree(tol):
    """Old and new outputs within `tol` of the old output's scale."""
    def agree(new, old):
        err = (new.float() - old.float()).abs().max().item()
        scale = old.float().abs().max().item()
        return err, f"output scale {scale:.2f}, bar {tol:g} of it", \
            err <= tol * scale
    return agree


def elementwise_agree(tol):
    """Old and new outputs within `tol` (1 + |old|) at every element."""
    def agree(new, old):
        d = (new - old).abs()
        worst = (d / (1 + old.abs())).max().item() / tol
        return d.max().item(), f"{worst:.3f} of the bar {tol:g} abs + rel", \
            worst <= 1
    return agree


def path_cases(old_fa, old_ssd, old_rg, gen, peaks):
    """(name, old call, new call, library call or None, agreement check,
    bound ms) at the serve prefill, recurrentgemma-9b's attention,
    mamba2-2.7b's scan and recurrentgemma-9b's RG-LRU scan (forward, and
    the whole backward as autograd runs it). Calls return tuples."""
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
               lambda f=old_fa, q=q, k=k, v=v, w=window: (f.flash_attention(
                   q, k, v, causal=True, window=w),),
               lambda q=q, k=k, v=v, w=window: (fa.flash_attention(
                   q, k, v, causal=True, window=w),),
               lambda qt=qt, kt=kt, vt=vt: torch.nn.functional.
               scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True,
                   enable_gqa=qt.shape[1] != kt.shape[1]),
               scale_agree(2 * cs.TOL_BF16_ROW),
               cs.bound_ms(q, k, v, True, window, peaks)[0])
    conv = rand((1, 1024, 5376), bf)
    Bs, Cs = conv[..., 5120:5248], conv[..., 5248:]
    xh = rand((1, 1024, 80, 64))
    a = -torch.nn.functional.softplus(rand((1, 1024, 80)))
    yield ("ssd", lambda: old_ssd.ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)[:1],
           lambda: ssd.ssd_scan_fwd(xh, a, Bs, Cs, chunk=128)[:1], None,
           scale_agree(2 * cs.TOL_SSD_PATH),
           cs.ssd_bound_ms(xh, a, Bs, Cs, 128, peaks)[0])
    shape = (1, cs.RG_SEQ, 4096)
    la = -(rand(shape) * 0.5).abs().requires_grad_(True)
    x, g = rand(shape).requires_grad_(True), rand(shape)
    yield ("rglru_forward", lambda: (old_rg.rglru_scan_fwd(la, x),),
           lambda: (rg.rglru_scan_fwd(la, x),), None,
           elementwise_agree(2 * cs.TOL_RGLRU),
           cs.rglru_bound_ms(x, peaks)[0])
    # the backward alone: autograd.grad over a graph kept for reuse
    h_old, h_new = old_rg.rglru_scan(la, x), rg.rglru_scan(la, x)
    yield ("rglru_backward",
           lambda: torch.autograd.grad(h_old, (la, x), g, retain_graph=True),
           lambda: torch.autograd.grad(h_new, (la, x), g, retain_graph=True),
           None, elementwise_agree(2 * cs.TOL_RGLRU_GRAD),
           cs.rglru_bound_ms(x, peaks, tensors=5)[0])


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
    old_fa, old_ssd, old_rg = import_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, bad = {"device": smi}, []
    for name, old_fn, new_fn, lib_fn, agree, bound in path_cases(
            old_fa, old_ssd, old_rg, gen, peaks):
        checks = [agree(n, o) for n, o in zip(new_fn(), old_fn())]
        ok = all(c[2] for c in checks)
        for err, desc, _ in checks:
            print(f"  {name}: old vs new max_abs_err {err:.3e} ({desc}) "
                  f"{'ok' if ok else 'FAIL'}")
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
             "library_ms": None, "library_back_to_back_ms": None,
             "bound_ms": bound}
        if lib_fn is not None:
            r["library_ms"] = cs.time_ms(lib_fn)
            r["library_back_to_back_ms"] = cs.time_back_to_back_ms(lib_fn)
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
