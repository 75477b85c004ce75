"""Paged KV cache for serving, ported from the JAX package's
`repro.kvcache`: K/V in fixed-size device pages with per-sequence page
tables; parked sequences evict their pages through the activation spool
and prefetch them back on the refill horizon.

    pages.py      page geometry, KVCacheConfig, the page allocator
    adapters.py   paged/resident split of the decode caches
    manager.py    PagedKVCache (spool-backed) and the DenseKVCache baseline
    scheduler.py  continuous-batching Server with quantum preemption
"""
from __future__ import annotations

from repro_torch.kvcache.manager import DenseKVCache, KVStats, PagedKVCache
from repro_torch.kvcache.pages import (KVCacheConfig, PageAllocator,
                                       PagePoolExhausted)
from repro_torch.kvcache.scheduler import (Request, Sequence, Server,
                                           ServeReport)

__all__ = [
    "KVCacheConfig", "PageAllocator", "PagePoolExhausted",
    "PagedKVCache", "DenseKVCache", "KVStats",
    "Server", "ServeReport", "Request", "Sequence", "build_manager",
]


def build_manager(kind: str, api, params, settings, kvcfg: KVCacheConfig,
                  n_slots: int, spool=None):
    """A KV-cache manager: kind in {"paged", "dense"}. An
    encoder-decoder and a vision model are refused: serving takes no
    encoder input, as in the JAX package, whose manager starts a
    sequence with the tokens alone (`repro/kvcache/manager.py:347-349`).
    They decode through `prefill`, then `decode_step` or
    `decode_step_paged` (ROADMAP §3)."""
    if api.enc_segments:
        raise ValueError(
            f"{api.cfg.name}: an encoder-decoder is not served through a "
            "KV-cache manager (no encoder input; prefill then decode_step "
            "it, ROADMAP §3)")
    if api.cfg.family == "vlm":
        raise ValueError(
            f"{api.cfg.name}: a vision model is not served through a "
            "KV-cache manager (no enc_embeddings input; prefill then "
            "decode_step or decode_step_paged it, ROADMAP §3)")
    if kind == "paged":
        return PagedKVCache(api, params, settings, kvcfg, n_slots, spool)
    if kind == "dense":
        return DenseKVCache(api, params, settings, kvcfg, n_slots)
    raise ValueError(f"unknown KV cache kind {kind!r}")
