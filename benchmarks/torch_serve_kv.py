"""Paged-KV serving on the port: paged vs dense on one request trace at
the same device-cache budget, after `benchmarks/serve_kv.py`.

Both servers replay one synthetic trace (same prompts, generation
budgets, slot count and attention extent) from one set of weights. The
dense baseline pins a full-length cache row per slot, so its live
concurrency is capped at the slot count; the paged server preempts a
sequence every `--quantum` tokens, evicting its pages (and its resident
ring or recurrent state) through the spool and prefetching them back
while the other slots decode.

    PYTHONPATH=src python -m benchmarks.torch_serve_kv --check    # card
    PYTHONPATH=src python -m benchmarks.torch_serve_kv --arch mamba2-2.7b \\
        --prompt-len 48 --max-new 16 --cache-len 64 --page-tokens 16 \\
        --quantum 4 --requests 8 --check
    PYTHONPATH=src python -m benchmarks.torch_serve_kv --device cpu \\
        --quick --check                                         # small

Per side: decode tok/s, slot occupancy, peak and mean live sequences,
TTFT and inter-token latency percentiles, device bytes and page traffic,
and each kernel's launches. `--check` exits 1 unless the paged tokens
and every logits row equal the dense ones bit for bit, paged holds at
least 2x dense's concurrent sequences within dense's device bytes plus
one page, sequences were evicted, everything evicted came back, and
every restored state (pages and resident leaves) equals the parked one
bit for bit. The runs go on the card unless `--device cpu`; without CUDA
they stop. `--out` writes the document as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kvcache import KVCacheConfig
from repro_torch.launch.serve import (build_kv_spool, build_runtime,
                                      make_server, synth_requests)

KERNELS = (flash_attention, ssd_scan, rglru_scan)


def state_snapshot(cache, seq):
    """Copies of a slot-resident sequence's resident state leaves and of
    its pages, keyed by path."""
    out = {}
    for si, entry in enumerate(cache.resident):
        for bid, tree in entry.items():
            for name, t in tree.items():
                out[f"{si}.{bid}.{name}"] = t[:, seq.slot].clone()
    if seq.pages:
        idx = torch.tensor(seq.pages, device=cache.device)
        for si, entry in enumerate(cache.pools):
            for bid, kv in entry.items():
                for name, pool in kv.items():
                    out[f"{si}.{bid}.{name}.pages"] = pool.index_select(
                        1, idx).clone()
    return out


def watch_parking(cache):
    """Wrap the paged cache's evict and restore so that every restored
    sequence's state is compared with what was parked, leaf by leaf,
    bitwise and dtype included. Returns a dict whose `restores` lists
    (rid, leaves compared) and `mismatched` names the leaves that
    differ ("rid <r>: <leaf>", or "rid <r>: leaves" for a changed set).
    The parked copies stay on the cache's device until their restore."""
    parked, seen = {}, {"restores": [], "mismatched": []}
    evict, restore = cache.evict, cache.restore

    def watched_evict(seq):
        parked[seq.rid] = state_snapshot(cache, seq)
        evict(seq)

    def watched_restore(seq, slot):
        restore(seq, slot)
        now, then = state_snapshot(cache, seq), parked.pop(seq.rid)
        if now.keys() != then.keys():
            seen["mismatched"].append(f"rid {seq.rid}: leaves")
        seen["mismatched"] += [
            f"rid {seq.rid}: {k}" for k in now.keys() & then.keys()
            if not (now[k].dtype == then[k].dtype
                    and torch.equal(now[k], then[k]))]
        seen["restores"].append((seq.rid, len(now)))

    cache.evict, cache.restore = watched_evict, watched_restore
    return seen


def run_side(runtime, kind, args, spool):
    """Serve the trace on one side; returns (server, report, launches,
    parking), `parking` being `watch_parking`'s record (paged only)."""
    cfg, api, params, settings = runtime
    kvcfg = KVCacheConfig(
        page_tokens=args.page_tokens, max_seq_len=args.cache_len,
        quantum=args.quantum if kind == "paged" else 0,
        prefetch_depth=args.prefetch_depth, dtype=cfg.dtype)
    server = make_server(api, params, settings, kvcfg, kind=kind,
                         n_slots=args.slots, spool=spool,
                         record_logits=True)
    parking = (watch_parking(server.cache) if kind == "paged"
               else {"restores": [], "mismatched": []})
    synth_requests(server, args.requests, args.prompt_len, args.max_new,
                   cfg.vocab_size, args.seed)
    before = [k.launches for k in KERNELS]
    report = server.run()
    launches = {k.__name__: k.launches - n0
                for k, n0 in zip(KERNELS, before)}
    return server, report, launches, parking


def bitwise_parity(a, b) -> bool:
    """Token ids and every sampled-from logits row, bitwise."""
    sa = {s.rid: s for s in a.finished}
    sb = {s.rid: s for s in b.finished}
    if set(sa) != set(sb):
        return False
    return all(sa[r].tokens == sb[r].tokens
               and len(sa[r].logits) == len(sb[r].logits) and all(
                   np.array_equal(x, y)
                   for x, y in zip(sa[r].logits, sb[r].logits))
               for r in sa)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="small-gpt")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--quantum", type=int, default=6)
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--kv-backend", default="fs",
                    help="spool backend kind or spec string (fs, mem, aio, "
                         "striped@2, ...)")
    ap.add_argument("--kv-dir", default=None)
    ap.add_argument("--kv-codec", default="byteplane",
                    choices=("raw", "zlib", "byteplane"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain paths)")
    ap.add_argument("--out", default=None, help="write the document as JSON")
    ap.add_argument("--trace", default=None, metavar="OUT.json")
    ap.add_argument("--quick", action="store_true",
                    help="small trace for a smoke run")
    ap.add_argument("--check", action="store_true",
                    help="assert the claims; exit 1 on a failure")
    args = ap.parse_args(argv)
    if args.quick:
        args.slots, args.requests = 2, 8
        args.prompt_len, args.max_new, args.cache_len = 12, 12, 32
        args.quantum = 3
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    runtime = build_runtime(args.arch, args.seed, device=args.device)
    if args.trace:
        obs.enable()
    spool = build_kv_spool(args.kv_backend, args.kv_dir, args.kv_codec,
                           cuda=args.device != "cpu")
    try:
        paged_srv, paged, paged_k, parking = run_side(runtime, "paged",
                                                      args, spool)
    finally:
        spool.close()
    dense_srv, dense, dense_k, _ = run_side(runtime, "dense", args, None)

    parity = bitwise_parity(paged_srv, dense_srv)
    page_bytes = paged_srv.cache.page_bytes
    ratios = {
        "peak_live": paged.peak_live / max(dense.peak_live, 1),
        "mean_live": paged.mean_live / max(dense.mean_live, 1e-9),
        "decode_tok_s": paged.decode_tok_s / max(dense.decode_tok_s, 1e-9),
        "device_bytes": paged.device_bytes / max(dense.device_bytes, 1),
    }
    checks = {
        "parity_bitwise": parity,
        "concurrency_2x": (paged.peak_live >= 2 * dense.peak_live
                           and paged.mean_live >= 2 * dense.mean_live),
        "device_budget": (paged.device_bytes
                          <= dense.device_bytes + page_bytes),
        "evictions_happened": paged.kv["evictions"] > 0,
        "restored_bitwise": (len(parking["restores"])
                             == paged.kv["evictions"]
                             and not parking["mismatched"]),
        "spool_balanced": (paged.kv["pages_evicted"]
                           == paged.kv["pages_restored"]
                           and paged.kv["bytes_evicted"]
                           == paged.kv["bytes_restored"]),
    }
    device = runtime[3].device
    if device != "cpu":
        device = torch.cuda.get_device_name(0)
    doc = {
        "config": {k: getattr(args, k) for k in
                   ("arch", "slots", "requests", "prompt_len", "max_new",
                    "cache_len", "page_tokens", "quantum",
                    "prefetch_depth", "kv_backend", "seed", "device")},
        "device_name": device,
        "page_bytes": page_bytes,
        "paged": paged.as_dict(), "dense": dense.as_dict(),
        "launches": {"paged": paged_k, "dense": dense_k},
        "ratios": ratios, "checks": checks,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
    for name, r, k in (("paged", paged, paged_k), ("dense", dense, dense_k)):
        print(f"{name}: {r.decode_tok_s:.0f} tok/s, live peak "
              f"{r.peak_live} mean {r.mean_live:.1f}, ttft p50 "
              f"{r.ttft_p50_ms:.1f}ms, itl p50 {r.itl_p50_ms:.1f}ms p99 "
              f"{r.itl_p99_ms:.1f}ms, {r.kv.get('evictions', 0)} evictions "
              f"({r.kv.get('pages_evicted', 0)} pages), "
              f"{r.device_bytes >> 10} KiB device; launches "
              + ", ".join(f"{n} {v}" for n, v in k.items()))
    print(f"concurrency x{ratios['peak_live']:.1f} peak / "
          f"x{ratios['mean_live']:.1f} mean at device-budget "
          f"x{ratios['device_bytes']:.3f}; parity={parity}; on {device}")
    if args.out:
        print(f"wrote {args.out}")
    if args.trace:
        print(f"trace -> "
              f"{obs.write_chrome_trace(args.trace, obs.get_tracer())}")
    if args.check:
        failed = [k for k, v in checks.items() if not v]
        if failed:
            print(f"CHECK FAILED: {failed}", file=sys.stderr)
            return 1
        print("all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
