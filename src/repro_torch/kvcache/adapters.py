"""Cache-layout adapters between the model's decode caches and the
paged KV pool, from the JAX package's `repro/kvcache/adapters.py`, on
torch tensors with an explicit device.

A model's decode cache is heterogeneous: full-attention K/V grows with
the sequence and is pageable; a sliding-window layer's ring cache is a
bounded buffer laid out by absolute position; rglru and ssm blocks
carry O(1) recurrent state; a cross block's K/V is the encoder's fixed
projection. Per block:

  paged    — full-attention K/V (window 0, or a window at least as long
             as the padded cache), carved into fixed-size pages in a
             shared device pool;
  resident — everything else (ring caches, the conv windows and the f32
             recurrent states of rglru and ssm blocks, cross K/V), kept
             as per-slot dense stacks like the classic decode cache, each
             leaf in its own dtype; they ride evictions as one
             per-sequence state blob, so a parked sequence restores bit
             for bit.

Right-padding a prompt to a page multiple is exact only when every
sequence-dependent cache entry is paged (causal masking hides the pad
K/V). Ring slots and recurrent states would take the pad tokens in, so
a model with any of them prefills at the exact prompt length.
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
    sequence state (ring caches, recurrent state)."""
    return any(b.mixer in ("rglru", "ssm")
               or (b.mixer == "attn" and not is_pageable(b, padded_seq_len))
               for seg in segments for b in seg.blocks)


def build_pools(segments, cfg: ModelConfig, n_pages: int, page_tokens: int,
                padded_seq_len: int, dtype, device) -> List[Dict]:
    """Device page pools: per segment {bid: {"k","v"}} of shape
    (n_repeat, n_pages, page_tokens, Hkv, head_dim). Page 0 is the null
    page."""
    dtype = dtype_of(dtype)
    pools: List[Dict] = []
    for seg, ids in zip(segments, paged_block_ids(segments,
                                                  padded_seq_len)):
        if not ids:      # attention-free: no head dim to resolve
            pools.append({})
            continue
        shape = (seg.n_repeat, n_pages, page_tokens, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
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
    `decode_step` reads, filtered to the resident blocks (K/V and conv
    windows in `dtype`, recurrent states in float32). The dense
    baseline passes empty `paged` sets to keep every block resident."""
    dtype = dtype_of(dtype)
    if paged is None:
        paged = paged_block_ids(segments, padded_seq_len)
    return [{f"b{i}": init_block_cache(bdef, cfg, n_slots, padded_seq_len,
                                       dtype, device,
                                       lead=(seg.n_repeat,))
             for i, bdef in enumerate(seg.blocks) if f"b{i}" not in ids}
            for seg, ids in zip(segments, paged)]
