"""Cache-layout adapters between the model's decode caches and the
paged KV pool, from the JAX package's `repro/kvcache/adapters.py`, on
torch tensors with an explicit device.

  paged    — full-attention K/V (window 0, or a window at least as long
             as the padded cache), carved into fixed-size pages in a
             shared device pool;
  resident — everything else (ring caches of windowed layers), kept as
             per-slot dense stacks like the classic decode cache; they
             ride evictions as one per-sequence state blob.

Right-padding a prompt to a page multiple is exact only when every
sequence-dependent cache entry is paged (causal masking hides the pad
K/V); otherwise prefill runs at the exact prompt length.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import SegmentDef, init_block_cache

__all__ = ["is_pageable", "paged_block_ids", "needs_exact_prefill",
           "build_pools", "build_resident"]


def is_pageable(bdef, padded_seq_len: int) -> bool:
    """Full-attention K/V pages; a window >= the padded cache length is
    full attention in disguise."""
    return bdef.mixer == "attn" and (
        not bdef.window or bdef.window >= padded_seq_len)


def paged_block_ids(segments: Tuple[SegmentDef, ...],
                    padded_seq_len: int) -> List[set]:
    """Per-segment set of block ids ("b0", ...) whose cache is paged."""
    return [{f"b{i}" for i, b in enumerate(seg.blocks)
             if is_pageable(b, padded_seq_len)} for seg in segments]


def needs_exact_prefill(segments: Tuple[SegmentDef, ...],
                        padded_seq_len: int) -> bool:
    """True when right-padding the prompt would leak pad tokens into
    sequence state (ring caches)."""
    return any(not is_pageable(b, padded_seq_len)
               for seg in segments for b in seg.blocks)


def build_pools(segments, cfg: ModelConfig, n_pages: int, page_tokens: int,
                padded_seq_len: int, dtype, device) -> List[Dict]:
    """Device page pools: per segment {bid: {"k","v"}} of shape
    (n_repeat, n_pages, page_tokens, Hkv, head_dim). Page 0 is the null
    page."""
    dtype = dtype_of(dtype)
    hd = cfg.resolved_head_dim
    pools: List[Dict] = []
    for seg, ids in zip(segments, paged_block_ids(segments,
                                                  padded_seq_len)):
        shape = (seg.n_repeat, n_pages, page_tokens, cfg.num_kv_heads, hd)
        pools.append({bid: {"k": torch.zeros(shape, dtype=dtype,
                                             device=device),
                            "v": torch.zeros(shape, dtype=dtype,
                                             device=device)}
                      for bid in sorted(ids)})
    return pools


def build_resident(segments, cfg: ModelConfig, n_slots: int,
                   padded_seq_len: int, dtype, device,
                   paged: List[set] = None) -> List[Dict]:
    """Per-slot dense stacks for the non-paged blocks: per segment
    {bid: cache entry} with leading dim n_repeat — the layout
    `decode_step` reads, filtered to the resident blocks. The dense
    baseline passes empty `paged` sets to keep every block resident."""
    dtype = dtype_of(dtype)
    if paged is None:
        paged = paged_block_ids(segments, padded_seq_len)
    return [{f"b{i}": init_block_cache(bdef, cfg, n_slots, padded_seq_len,
                                       dtype, device,
                                       lead=(seg.n_repeat,))
             for i, bdef in enumerate(seg.blocks) if f"b{i}" not in ids}
            for seg, ids in zip(segments, paged)]
