"""Serving entry point of the port: continuous batching over a paged (or
dense) KV cache, from the JAX package's `repro/launch/serve.py`.

With `--cache paged` the KV lives in fixed-size device pages; sequences
preempted by `--quantum` evict their pages through the activation spool
to `--kv-backend` (`fs`: a directory standing in for an SSD, `mem`: host
RAM) and prefetch them back while the other slots decode. `--cache
dense` is the per-slot dense layout at the same attention extent: same
logits bitwise, concurrency capped at the slot count. Prefill attention
runs the hand-written CUDA flash-attention kernel (`--attn-impl cuda`,
the default on the card); `--attn-impl torch` runs the plain path.

  python -m repro_torch.launch.serve --arch gpt-h8192-l4 --batch 4 \\
      --requests 12 --prompt-len 1024 --max-new 24 --cache-len 1056 \\
      --quantum 8 --kv-codec raw
  python -m repro_torch.launch.serve --arch small-gpt --device cpu \\
      --attn-impl torch --quantum 3

`--trace OUT.json` writes a Chrome/Perfetto trace of the run: `kv.*`
page events, `serve.*` scheduling and the spool's `spool.*` / `io.*`
lanes, with the JAX package's names.

Runs on the card unless `--device cpu` is given; without CUDA it stops
rather than fall back to the CPU.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import SpoolIoConfig, resolve_config
from repro_torch.core.spool import build_spool
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kvcache import KVCacheConfig, Server, build_manager
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings


def build_runtime(arch: str, seed: int = 0, *, device: str = "cuda",
                  attn_impl: Optional[str] = None):
    """(cfg, api, params, settings) for an arch, with weights made on
    `device` from an explicit generator seeded with `seed`. attn_impl
    defaults to "cuda" on the card and "torch" on the CPU."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                           "available (pass device='cpu' to run on the "
                           "CPU)")
    cfg = resolve_config(arch)
    if not cfg.has_decode:
        raise ValueError(f"{arch}: encoder-only arch has no decode step")
    api = build_model(cfg)
    settings = RunSettings(
        attn_impl=attn_impl or ("torch" if device == "cpu" else "cuda"),
        attn_chunk=256, param_dtype=cfg.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = api.init(gen)
    return cfg, api, params, settings


def build_kv_spool(backend: str = "fs", directory=None,
                   codec: str = "byteplane"):
    """A spool for KV pages: the training activations' data plane with
    the small-tensor bypass off (pages must actually reach storage)."""
    return build_spool(SpoolIoConfig(backend=backend, directory=directory,
                                     codec=codec), min_offload_elements=0)


def synth_requests(server: Server, n: int, prompt_len: int, max_new: int,
                   vocab: int, seed: int) -> None:
    """Submit the synthetic trace: prompt lengths uniform in
    [prompt_len//2, prompt_len], fixed generation budget. numpy-seeded,
    so the JAX package and the port replay the same trace."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        server.submit(rng.integers(0, vocab, plen), max_new)


def make_server(api, params, settings, kvcfg: KVCacheConfig, *,
                kind: str = "paged", n_slots: int = 8, spool=None,
                record_logits: bool = False) -> Server:
    cache = build_manager(kind, api, params, settings, kvcfg, n_slots, spool)
    return Server(cache, record_logits=record_logits)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="small-gpt")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128,
                    help="max logical sequence length (prompt + gen)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", choices=("paged", "dense"), default="paged")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="device page-pool size (0: worst-case sizing)")
    ap.add_argument("--quantum", type=int, default=0,
                    help="decode tokens before preemption (0: run to "
                         "retirement)")
    ap.add_argument("--max-live", type=int, default=0,
                    help="admission cap on live sequences (0: none)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="parked sequences prefetched ahead of refill")
    ap.add_argument("--kv-backend", default="fs", choices=("fs", "mem"),
                    help="spool storage for evicted pages")
    ap.add_argument("--kv-dir", default=None,
                    help="spool directory (default: fresh temp dir)")
    ap.add_argument("--kv-codec", default="byteplane",
                    choices=("raw", "zlib", "byteplane"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain paths")
    ap.add_argument("--attn-impl", default=None, choices=("cuda", "torch"),
                    help="prefill attention (default: cuda on the card, "
                         "torch on the CPU)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto trace (kv.* page events, "
                         "serve.* scheduling, io.* spool lanes)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the serve report as JSON")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, runtime=None, *,
        record_logits: bool = False):
    """Serve the synthetic trace the args describe. Returns (server,
    report); `runtime` reuses a `build_runtime` result."""
    cfg, api, params, settings = runtime or build_runtime(
        args.arch, args.seed, device=args.device, attn_impl=args.attn_impl)
    kvcfg = KVCacheConfig(
        page_tokens=args.page_tokens, pool_pages=args.pool_pages,
        max_seq_len=args.cache_len, prefetch_depth=args.prefetch_depth,
        quantum=args.quantum, max_live=args.max_live, dtype=cfg.dtype)
    spool = (build_kv_spool(args.kv_backend, args.kv_dir, args.kv_codec)
             if args.cache == "paged" else None)
    try:
        server = make_server(api, params, settings, kvcfg, kind=args.cache,
                             n_slots=args.batch, spool=spool,
                             record_logits=record_logits)
        synth_requests(server, args.requests, args.prompt_len,
                       args.max_new, cfg.vocab_size, args.seed)
        report = server.run()
    finally:
        if spool is not None:
            spool.close()
    return server, report


def report_lines(r) -> List[str]:
    lines = [
        f"served {r.requests} requests on {r.n_slots} slots "
        f"({r.cache_kind} cache) in {r.wall_time_s:.2f}s",
        f"prefill: {r.prompt_tokens} prompt tokens; generated: "
        f"{r.generated_tokens} tokens ({r.gen_tok_s:.0f} tok/s overall)",
        f"decode:  {r.decode_slot_tokens} slot-tokens over "
        f"{r.decode_steps} steps ({r.decode_tok_s:.0f} tok/s, "
        f"occupancy {r.slot_occupancy:.2f})",
        f"live:    peak {r.peak_live} mean {r.mean_live:.1f} "
        f"(preemptions {r.preemptions})",
        f"latency: ttft p50 {r.ttft_p50_ms:.1f}ms p99 {r.ttft_p99_ms:.1f}ms;"
        f" inter-token p50 {r.itl_p50_ms:.1f}ms p95 {r.itl_p95_ms:.1f}ms "
        f"p99 {r.itl_p99_ms:.1f}ms",
    ]
    if r.kv.get("evictions") or r.kv.get("pages_allocated"):
        lines.append(
            f"kv:      {r.kv['pages_allocated']} pages allocated, "
            f"{r.kv['pages_evicted']} evicted / {r.kv['pages_restored']} "
            f"restored ({r.kv['evictions']} evictions, "
            f"{r.kv['restores']} restores)")
    lines.append(
        f"time:    prefill {r.kv['prefill_s']:.3f}s, decode "
        f"{r.decode_time_s:.3f}s, evict {r.kv['evict_s']:.3f}s, restore "
        f"{r.kv['restore_s']:.3f}s of {r.wall_time_s:.3f}s wall")
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    owns_tracer = args.trace is not None and not obs.is_enabled()
    if args.trace:
        obs.enable()
    launches0 = flash_attention.launches
    try:
        _, report = run(args)
        if args.trace:
            # the spool is closed: every span has ended
            path = obs.write_chrome_trace(args.trace, obs.get_tracer())
    finally:
        if owns_tracer:
            obs.disable()
    device = (torch.cuda.get_device_name(torch.device(args.device))
              if args.device != "cpu" else "cpu")
    print(f"device:  {device}")
    for line in report_lines(report):
        print(line)
    print(f"kernels: flash_attention launches "
          f"{flash_attention.launches - launches0}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report.as_dict(), f, indent=2, sort_keys=True)
        print(f"report -> {args.json_out}")
    if args.trace:
        print(f"trace -> {path}")


if __name__ == "__main__":
    main()
