"""KV-cache managers of the port: the paged, spool-backed device cache
and the dense baseline, from the JAX package's `repro/kvcache/manager.py`.

`PagedKVCache` keeps K/V in fixed-size pages in a shared device pool;
each sequence owns a page table, and a parked (preempted) sequence's
pages are evicted through the activation spool — one lease per sequence
(`spool.lease(f"kv{rid}")`), one blob per logical page, so retiring the
sequence drops every blob it ever spooled. `DenseKVCache` is the classic
one-row-per-slot layout behind the same interface. Both use the same
attention extent (`KVCacheConfig.padded_seq_len`), so paged and dense
logits are bitwise equal on one request trace.

Where JAX donates buffers to jitted steps, the port updates the pools,
resident entries and dense caches IN PLACE (`index_copy_`, `index_put_`
and slice assignment). Model work runs under `torch.inference_mode()`.
The `kv.*` spans, instants and gauges are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tree import tree_nbytes
from repro_torch.kvcache import adapters
from repro_torch.kvcache.pages import KVCacheConfig, PageAllocator
from repro_torch.models.api import ModelApi
from repro_torch.models.transformer import RunSettings

__all__ = ["PagedKVCache", "DenseKVCache", "KVStats"]


@dataclass
class KVStats:
    """Counters for the serve report."""
    pages_allocated: int = 0
    page_faults: int = 0            # decode-growth allocs (pos crossed a page)
    pages_evicted: int = 0
    pages_restored: int = 0
    bytes_evicted: int = 0
    bytes_restored: int = 0
    evictions: int = 0              # sequence park events
    restores: int = 0               # sequence un-park events
    prefills: int = 0
    # host time inside each phase; every phase ends in a device->host
    # or host->device copy, so these include the device work they wait on
    prefill_s: float = 0.0
    evict_s: float = 0.0
    restore_s: float = 0.0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _align_up(n: int, m: int) -> int:
    return -(-n // m) * m


class _ManagerBase:
    """Per-slot position / last-token arrays and the prompt-bucketing
    rule, shared so paged and dense run the very same prefill."""

    def __init__(self, api: ModelApi, params, settings: RunSettings,
                 kvcfg: KVCacheConfig, n_slots: int):
        self.api = api
        self.cfg = api.cfg
        self.params = params
        self.settings = settings
        self.device = torch.device(settings.device)
        self.kvcfg = kvcfg.validate()
        self.n_slots = n_slots
        self.P = kvcfg.page_tokens
        self.S = kvcfg.padded_seq_len
        self.max_pages = kvcfg.max_pages
        self.exact_prefill = adapters.needs_exact_prefill(api.segments,
                                                          self.S)
        self.pos = np.zeros((n_slots,), np.int64)
        self.last_tok = np.zeros((n_slots,), np.int64)
        self.stats = KVStats()

    def bind_token(self, seq, token: int) -> None:
        """Stage the first sampled token as the slot's next decode input
        (its K/V is written by the decode step that consumes it)."""
        seq.last_tok = token
        self.last_tok[seq.slot] = token

    def advance(self, seq, token: int) -> None:
        """Record the sampled token; the slot writes it next step."""
        seq.pos += 1
        seq.last_tok = token
        self.pos[seq.slot] = seq.pos
        self.last_tok[seq.slot] = token

    def bucket_for(self, plen: int) -> int:
        """Prefill length: page-aligned right padding when every
        sequence state is paged (pad K/V is masked by causality), the
        exact length otherwise."""
        return plen if self.exact_prefill else _align_up(plen, self.P)

    def _prefill(self, prompt: np.ndarray, bucket: int):
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :len(prompt)] = torch.from_numpy(prompt.astype(np.int64))
        return self.api.forward(self.params,
                                {"tokens": toks.to(self.device)},
                                self.settings, emit_cache=True,
                                cache_len=self.S)

    def _host_tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)


# ======================================================================
# Paged manager
# ======================================================================

class PagedKVCache(_ManagerBase):
    kind = "paged"
    can_evict = True

    @torch.inference_mode()
    def __init__(self, api: ModelApi, params, settings: RunSettings,
                 kvcfg: KVCacheConfig, n_slots: int, spool):
        super().__init__(api, params, settings, kvcfg, n_slots)
        if spool is None:
            raise ValueError("PagedKVCache needs a spool for eviction")
        self.spool = spool
        self.n_pool_pages = kvcfg.resolve_pool_pages(n_slots)
        self.alloc = PageAllocator(self.n_pool_pages)
        if not any(adapters.paged_block_ids(api.segments, self.S)):
            raise ValueError(f"{self.cfg.name}: no pageable "
                             "(full-attention) cache entries")
        self.pools = adapters.build_pools(
            api.segments, self.cfg, self.n_pool_pages, self.P, self.S,
            kvcfg.dtype, self.device)
        self.resident = adapters.build_resident(
            api.segments, self.cfg, n_slots, self.S, kvcfg.dtype,
            self.device)
        self.tables = np.zeros((n_slots, self.max_pages), np.int64)

    @property
    def device_bytes(self) -> int:
        return (tree_nbytes(self.pools)
                + tree_nbytes(self.resident))

    # ------------------------------------------------------- decode

    @torch.inference_mode()
    def decode(self) -> np.ndarray:
        """One decode step for every slot; returns (B, V) f32 logits.
        Idle slots decode a dummy token into the null page."""
        logits = self.api.decode_step_paged(
            self.params, self.pools, self.resident,
            self._host_tensor(self.tables),
            {"tokens": self._host_tensor(self.last_tok[:, None])},
            self._host_tensor(self.pos), self.settings)
        return logits[:, 0].cpu().numpy()

    def fault_in(self, seq) -> None:
        """Allocate the page holding position seq.pos before the decode
        step writes into it."""
        needed = seq.pos // self.P + 1
        if needed <= len(seq.pages):
            return
        grow = needed - len(seq.pages)
        ids = self.alloc.alloc(grow)
        self.tables[seq.slot, len(seq.pages):needed] = ids
        seq.pages.extend(ids)
        self.stats.pages_allocated += grow
        self.stats.page_faults += grow
        obs.instant("kv.alloc", cat="kv", seq=seq.rid, pages=grow,
                    fault=True)
        obs.gauge("kv.pages_in_use", self.alloc.in_use)

    # ------------------------------------------------------- lifecycle

    @torch.inference_mode()
    def start(self, seq, slot: int) -> np.ndarray:
        """Prefill a new sequence into pages bound to `slot`; returns the
        (V,) logits row at the last prompt position."""
        t0 = time.perf_counter()
        plen = len(seq.prompt)
        bucket = self.bucket_for(plen)
        n_pages = max(1, -(-bucket // self.P))
        ids = self.alloc.alloc(n_pages)
        seq.tx = self.spool.lease(f"kv{seq.rid}")
        with obs.span("kv.prefill", cat="kv", seq=seq.rid, tokens=plen,
                      pages=n_pages):
            logits, caches = self._prefill(seq.prompt, bucket)
            idx = self._host_tensor(np.asarray(ids, np.int64))
            pad = n_pages * self.P - bucket
            for seg_i, entry in enumerate(self.pools):
                for bid, kv in entry.items():
                    for name, pool in kv.items():
                        a = caches[seg_i][bid][name][:, 0, :bucket]
                        if pad:
                            a = torch.nn.functional.pad(
                                a, (0, 0, 0, 0, 0, pad))
                        pool.index_copy_(1, idx, a.reshape(
                            a.shape[0], n_pages, self.P, *a.shape[2:]).to(
                                pool.dtype))
            for seg_i, entry in enumerate(self.resident):
                for bid, tree in entry.items():
                    for name, t in tree.items():
                        t[:, slot] = caches[seg_i][bid][name][:, 0].to(
                            t.dtype)
            row = logits[0, plen - 1].cpu().numpy()
        seq.pages = list(ids)
        seq.slot = slot
        seq.pos = plen
        self.tables[slot] = 0
        self.tables[slot, :n_pages] = ids
        self.pos[slot] = plen
        self.stats.pages_allocated += n_pages
        self.stats.prefills += 1
        self.stats.prefill_s += time.perf_counter() - t0
        obs.instant("kv.alloc", cat="kv", seq=seq.rid, pages=n_pages)
        obs.gauge("kv.pages_in_use", self.alloc.in_use)
        return row

    @torch.inference_mode()
    def evict(self, seq) -> None:
        """Park a slot-resident sequence: copy its pages (and resident
        ring state) to host, stream them to the spool — one blob per
        logical page — free the device pages and unbind the slot. The
        spool writes are async; decode of the other slots goes on."""
        if seq.slot is None or seq.pages is None:
            raise ValueError(f"sequence {seq.rid} is not slot-resident")
        t0 = time.perf_counter()
        n = len(seq.pages)
        with obs.span("kv.evict", cat="kv", seq=seq.rid, pages=n):
            idx = self._host_tensor(np.asarray(seq.pages, np.int64))
            host = [(f"{seg_i}.{bid}",
                     {name: pool.index_select(1, idx).cpu()
                      for name, pool in kv.items()})
                    for seg_i, entry in enumerate(self.pools)
                    for bid, kv in entry.items()]
            nbytes = 0
            for j in range(n):
                blob = {name: {k: t[:, j] for k, t in kv.items()}
                        for name, kv in host}
                nbytes += tree_nbytes(blob)
                seq.tx.offload(j, blob)
            # an explicit copy: on a CPU device .cpu() would return a view
            # of the slot's rows, which the slot's next occupant overwrites
            st = {f"{seg_i}.{bid}": {name: t[:, seq.slot].to("cpu",
                                                             copy=True)
                                     for name, t in tree.items()}
                  for seg_i, entry in enumerate(self.resident)
                  for bid, tree in entry.items()}
            if st:
                nbytes += tree_nbytes(st)
                seq.tx.offload("st", st)
        self.alloc.free(seq.pages)
        self._unbind(seq)
        seq.n_pages = n
        seq.pages = None
        self.stats.pages_evicted += n
        self.stats.bytes_evicted += nbytes
        self.stats.evictions += 1
        self.stats.evict_s += time.perf_counter() - t0
        obs.instant("kv.evicted", cat="kv", seq=seq.rid, pages=n,
                    bytes=nbytes)
        obs.gauge("kv.pages_in_use", self.alloc.in_use)

    def prefetch(self, seq) -> None:
        """Start async loads of a parked sequence's pages (issued when it
        enters the refill horizon, so they stream back while the other
        slots decode)."""
        if seq.pages is not None or seq.tx is None:
            return
        for j in range(seq.n_pages):
            seq.tx.prefetch(j)
        if seq.tx.has_stage("st"):
            seq.tx.prefetch("st")
        obs.instant("kv.prefetch", cat="kv", seq=seq.rid,
                    pages=seq.n_pages)

    @torch.inference_mode()
    def restore(self, seq, slot: int) -> None:
        """Un-park a sequence into `slot`: consume its pages from the
        spool (a prefetch hit or a forwarded store makes this no read)
        and copy them into freshly allocated device pages."""
        if seq.pages is not None:
            raise ValueError(f"sequence {seq.rid} is not parked")
        t0 = time.perf_counter()
        n = seq.n_pages
        with obs.span("kv.restore", cat="kv", seq=seq.rid, pages=n):
            ids = self.alloc.alloc(n)
            blobs = [seq.tx.consume(j) for j in range(n)]
            nbytes = sum(tree_nbytes(b) for b in blobs)
            idx = self._host_tensor(np.asarray(ids, np.int64))
            for seg_i, entry in enumerate(self.pools):
                for bid, kv in entry.items():
                    for name, pool in kv.items():
                        pages = torch.stack(
                            [b[f"{seg_i}.{bid}"][name] for b in blobs], dim=1)
                        pool.index_copy_(1, idx, pages.to(self.device))
            if seq.tx.has_stage("st"):
                st = seq.tx.consume("st")
                nbytes += tree_nbytes(st)
                for seg_i, entry in enumerate(self.resident):
                    for bid, tree in entry.items():
                        for name, t in tree.items():
                            t[:, slot] = st[f"{seg_i}.{bid}"][name].to(
                                self.device)
        seq.pages = ids
        seq.slot = slot
        self.tables[slot] = 0
        self.tables[slot, :n] = ids
        self.pos[slot] = seq.pos
        self.last_tok[slot] = seq.last_tok
        self.stats.pages_allocated += n
        self.stats.pages_restored += n
        self.stats.bytes_restored += nbytes
        self.stats.restores += 1
        self.stats.restore_s += time.perf_counter() - t0
        obs.instant("kv.restored", cat="kv", seq=seq.rid, pages=n,
                    bytes=nbytes)
        obs.gauge("kv.pages_in_use", self.alloc.in_use)

    def release(self, seq) -> None:
        """Retire a sequence: free its device pages if resident and drop
        every spooled blob through the lease's close."""
        if seq.pages is not None:
            self.alloc.free(seq.pages)
            if seq.slot is not None:
                self._unbind(seq)
            seq.pages = None
        if seq.tx is not None:
            seq.tx.close()
            seq.tx = None
        obs.gauge("kv.pages_in_use", self.alloc.in_use)

    def _unbind(self, seq) -> None:
        self.tables[seq.slot] = 0
        self.pos[seq.slot] = 0
        self.last_tok[seq.slot] = 0
        seq.slot = None


# ======================================================================
# Dense baseline
# ======================================================================

class DenseKVCache(_ManagerBase):
    """Every slot owns full-length cache rows (`padded_seq_len`, the
    paged attention extent). No eviction: concurrency is capped at the
    slot count."""

    kind = "dense"
    can_evict = False

    @torch.inference_mode()
    def __init__(self, api: ModelApi, params, settings: RunSettings,
                 kvcfg: KVCacheConfig, n_slots: int):
        super().__init__(api, params, settings, kvcfg, n_slots)
        self.caches = adapters.build_resident(
            api.segments, self.cfg, n_slots, self.S, kvcfg.dtype,
            self.device, paged=[set() for _ in api.segments])

    @property
    def device_bytes(self) -> int:
        return tree_nbytes(self.caches)

    @torch.inference_mode()
    def decode(self) -> np.ndarray:
        logits = self.api.decode_step(
            self.params, self.caches,
            {"tokens": self._host_tensor(self.last_tok[:, None])},
            self._host_tensor(self.pos), self.settings)
        return logits[:, 0].cpu().numpy()

    def fault_in(self, seq) -> None:   # dense rows never fault
        pass

    @torch.inference_mode()
    def start(self, seq, slot: int) -> np.ndarray:
        t0 = time.perf_counter()
        plen = len(seq.prompt)
        with obs.span("kv.prefill", cat="kv", seq=seq.rid, tokens=plen):
            logits, caches = self._prefill(seq.prompt, self.bucket_for(plen))
            for seg_i, entry in enumerate(self.caches):
                for bid, tree in entry.items():
                    for name, t in tree.items():
                        t[:, slot] = caches[seg_i][bid][name][:, 0].to(
                            t.dtype)
            row = logits[0, plen - 1].cpu().numpy()
        seq.slot = slot
        seq.pos = plen
        self.pos[slot] = plen
        self.stats.prefills += 1
        self.stats.prefill_s += time.perf_counter() - t0
        return row

    def evict(self, seq) -> None:
        raise RuntimeError("dense KV cache cannot evict — sequences pin "
                           "their slot until retirement")

    def prefetch(self, seq) -> None:
        pass

    def restore(self, seq, slot: int) -> None:
        raise RuntimeError("dense KV cache has nothing to restore")

    def release(self, seq) -> None:
        if seq.slot is not None:
            self.pos[seq.slot] = 0
            self.last_tok[seq.slot] = 0
            seq.slot = None
