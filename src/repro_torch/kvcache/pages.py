"""Paged KV-cache primitives: page geometry and the device page
allocator, copied from the JAX package's `repro/kvcache/pages.py`.

A page holds `page_tokens` consecutive tokens of one sequence's K/V
across every pageable layer (the pool tensors carry the layer dimension,
so one page id addresses the same page slot in every layer's pool — the
blob the spool sees on eviction).

Physical page 0 is the reserved null page: idle decode slots (and table
entries past a sequence's allocated length) point at it, so the decode
step needs no batch-size-dependent branch; nobody attends to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

__all__ = ["KVCacheConfig", "PageAllocator", "PagePoolExhausted"]


class PagePoolExhausted(RuntimeError):
    """The device page pool has no free pages left (only possible when
    `pool_pages` is set tighter than n_slots * max_pages + 1)."""


@dataclass(frozen=True)
class KVCacheConfig:
    """Knobs of the paged KV cache (see the JAX package's docstring).

    page_tokens:    tokens per KV page (per layer).
    pool_pages:     device pool size including the null page; 0 -> the
                    worst case n_slots * max_pages + 1.
    max_seq_len:    logical length cap (prompt + generation), rounded up
                    to a page multiple; also the dense baseline's
                    per-slot cache length, so both see one extent.
    prefetch_depth: parked sequences prefetched ahead of slot refill.
    quantum:        decode tokens before preemption (0 = run to
                    retirement).
    max_live:       admission cap on live sequences (0 = unbounded).
    dtype:          KV pool dtype.
    """
    page_tokens: int = 16
    pool_pages: int = 0
    max_seq_len: int = 256
    prefetch_depth: int = 2
    quantum: int = 0
    max_live: int = 0
    dtype: str = "bfloat16"

    @property
    def max_pages(self) -> int:
        return -(-self.max_seq_len // self.page_tokens)

    @property
    def padded_seq_len(self) -> int:
        """max_seq_len rounded up to whole pages: the gathered attention
        extent and the dense baseline's cache length."""
        return self.max_pages * self.page_tokens

    def resolve_pool_pages(self, n_slots: int) -> int:
        if self.pool_pages:
            return self.pool_pages
        return n_slots * self.max_pages + 1

    def validate(self) -> "KVCacheConfig":
        if self.page_tokens <= 0:
            raise ValueError(f"page_tokens {self.page_tokens} <= 0")
        if self.max_seq_len < self.page_tokens:
            raise ValueError(f"max_seq_len {self.max_seq_len} < "
                             f"page_tokens {self.page_tokens}")
        if min(self.prefetch_depth, self.quantum, self.max_live) < 0:
            raise ValueError("prefetch_depth, quantum and max_live must "
                             "be >= 0")
        if self.pool_pages and self.pool_pages < 2:
            raise ValueError("pool_pages needs >= 1 page beyond the null")
        return self


class PageAllocator:
    """Free-list allocator over physical page ids [1, n_pages).

    Deterministic: freed pages are recycled LIFO, fresh pages are handed
    out in ascending id order, so one request trace always gives one
    physical placement."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("pool needs the null page plus one")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.high_water = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.n_pages - 1} (raise pool_pages or lower "
                f"max_live/quantum pressure)")
        out = [self._free.pop() for _ in range(n)]
        self.high_water = max(self.high_water, self.in_use)
        return out

    def free(self, ids: List[int]) -> None:
        for pid in ids:
            if not 0 < pid < self.n_pages:
                raise ValueError(f"page id {pid} out of range")
            self._free.append(pid)
