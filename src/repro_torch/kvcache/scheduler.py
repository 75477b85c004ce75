"""Continuous-batching serve scheduler over a KV-cache manager, copied
from the JAX package's `repro/kvcache/scheduler.py`, with its `serve.*`
spans, instants and gauge.

The server owns B decode slots and a queue of requests. Slots turn over
individually: when a sequence retires its slot refills from the new
queue (up to `max_live`) or the resume queue of parked sequences, while
the other slots keep decoding. With a paged cache and a scheduling
`quantum`, a sequence that has decoded `quantum` tokens since it was
bound is preempted whenever other work is waiting — its pages are
evicted through the spool — so live sequences can exceed the slot count.

Everything is deterministic (FIFO queues, ascending slot refill, LIFO
page recycling): one request trace gives one schedule log, one set of
tokens and, paged or dense, bitwise-identical logits. Accounting
invariants: the first sampled token of a request (from prefill logits)
counts in `generated_tokens`; idle slots never count as decode tokens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.cache.horizon import reuse_horizon

__all__ = ["Request", "Sequence", "Server", "ServeReport"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (plen,) int32
    max_new: int


class Sequence:
    """One in-flight request plus the state the KV manager hangs off it
    (slot binding, page list, spool lease)."""

    def __init__(self, req: Request, t_submit: float):
        self.rid = req.rid
        self.prompt = np.asarray(req.prompt, np.int32)
        self.max_new = req.max_new
        self.tokens: List[int] = []
        self.pos = 0                 # next KV write position
        self.last_tok = 0
        self.slot: Optional[int] = None
        self.pages: Optional[List[int]] = None   # device pages (paged)
        self.n_pages = 0             # page count while parked
        self.tx = None               # spool lease (paged)
        self.q_used = 0              # decode tokens since last bind
        self.preemptions = 0
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.token_times: List[float] = []
        self.logits: Optional[List[np.ndarray]] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclass
class ServeReport:
    requests: int = 0
    n_slots: int = 0
    decode_steps: int = 0
    prompt_tokens: int = 0          # true prompt tokens, no padding
    generated_tokens: int = 0       # every sampled token, incl. first
    decode_slot_tokens: int = 0     # decode-step tokens on live slots
    decode_time_s: float = 0.0
    wall_time_s: float = 0.0
    decode_tok_s: float = 0.0
    gen_tok_s: float = 0.0
    slot_occupancy: float = 0.0     # live-slot fraction of decode grid
    peak_live: int = 0
    mean_live: float = 0.0
    preemptions: int = 0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    itl_p50_ms: float = 0.0         # inter-token latency
    itl_p95_ms: float = 0.0
    itl_p99_ms: float = 0.0
    cache_kind: str = ""
    device_bytes: int = 0
    kv: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Server:
    """Continuous-batching decode loop over a KV-cache manager.

    cache:          PagedKVCache or DenseKVCache (manager.py).
    record_logits:  keep every sampled-from logits row per sequence
                    (numpy f32), for the bitwise parity checks.

    Sampling is greedy (argmax); a sequence runs to its max_new tokens.
    """

    def __init__(self, cache, *, record_logits: bool = False):
        self.cache = cache
        self.kvcfg = cache.kvcfg
        self.n_slots = cache.n_slots
        self.record_logits = record_logits
        self.time = time.perf_counter
        self.new_q: deque = deque()
        self.resume_q: deque = deque()
        self.slots: List[Optional[Sequence]] = [None] * self.n_slots
        self.finished: List[Sequence] = []
        self.schedule_log: List = []     # (step, event, rid, slot)
        self._next_rid = 0
        self.decode_steps = 0
        self.decode_slot_tokens = 0
        self._live_sum = 0
        self._peak_live = 0
        self._decode_time = 0.0

    # ------------------------------------------------------- intake

    def submit(self, prompt, max_new: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.kvcfg.max_seq_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds "
                f"max_seq_len={self.kvcfg.max_seq_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.new_q.append(Sequence(Request(rid, prompt, max_new),
                                   self.time()))
        return rid

    # ------------------------------------------------------- helpers

    @property
    def live(self) -> int:
        """Sequences mid-generation: bound to a slot or parked."""
        return (sum(1 for s in self.slots if s is not None)
                + len(self.resume_q))

    def _log(self, event: str, seq: Sequence, slot) -> None:
        self.schedule_log.append((self.decode_steps, event, seq.rid, slot))
        obs.instant(f"serve.{event}", cat="serve", rid=seq.rid,
                    slot=slot, step=self.decode_steps)

    def _emit_token(self, seq: Sequence, row: np.ndarray) -> int:
        tok = int(np.argmax(row))
        now = self.time()
        if seq.t_first is None:
            seq.t_first = now
        seq.token_times.append(now)
        seq.tokens.append(tok)
        if self.record_logits:
            if seq.logits is None:
                seq.logits = []
            seq.logits.append(np.asarray(row, np.float32))
        return tok

    def _admit_ok(self) -> bool:
        cap = self.kvcfg.max_live
        return not cap or self.live < cap

    def _refill(self) -> None:
        """New requests first (up to `max_live`), then parked sequences
        round-robin; a preempted sequence waits behind fresh admissions
        with its pages prefetching, and the quantum keeps everyone
        making progress."""
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            if self.new_q and self._admit_ok():
                seq = self.new_q.popleft()
                row = self.cache.start(seq, slot)
                seq.q_used = 0
                self.slots[slot] = seq
                self._log("start", seq, slot)
                tok = self._emit_token(seq, row)
                self.cache.bind_token(seq, tok)
                self._finish_if_done(seq, slot)
            elif self.resume_q:
                seq = self.resume_q.popleft()
                self.cache.restore(seq, slot)
                seq.q_used = 0
                self.slots[slot] = seq
                self._log("resume", seq, slot)

    def _finish_if_done(self, seq: Sequence, slot: int) -> bool:
        if seq.done:
            self.cache.release(seq)
            self.slots[slot] = None
            self.finished.append(seq)
            self._log("retire", seq, slot)
            return True
        return False

    # ------------------------------------------------------- main loop

    def step(self) -> None:
        """One iteration: refill, prefetch, fault-in, decode, sample,
        retire/preempt."""
        self._refill()
        # the refill horizon: sequences about to re-enter decode
        for seq in reuse_horizon(self.resume_q,
                                 depth=self.kvcfg.prefetch_depth):
            self.cache.prefetch(seq)
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        for _, seq in active:
            self.cache.fault_in(seq)
        live = self.live
        self._live_sum += live
        self._peak_live = max(self._peak_live, live)
        obs.gauge("serve.live", live)
        t0 = self.time()
        with obs.span("serve.decode", cat="serve",
                      step=self.decode_steps, active=len(active),
                      live=live):
            logits = self.cache.decode()
        self._decode_time += self.time() - t0
        self.decode_steps += 1
        self.decode_slot_tokens += len(active)
        quantum = self.kvcfg.quantum
        for slot, seq in active:
            tok = self._emit_token(seq, logits[slot])
            self.cache.advance(seq, tok)
            seq.q_used += 1
            if self._finish_if_done(seq, slot):
                continue
            if (quantum and self.cache.can_evict and seq.q_used >= quantum
                    and (self.new_q or self.resume_q)):
                self.cache.evict(seq)
                seq.preemptions += 1
                self.slots[slot] = None
                self.resume_q.append(seq)
                self._log("preempt", seq, slot)

    def run(self) -> ServeReport:
        """Drain every queue and slot: the loop ends exactly when no
        sequence is waiting, parked or bound."""
        t0 = self.time()
        with obs.span("serve.run", cat="serve",
                      requests=len(self.new_q)):
            while self.new_q or self.resume_q or any(
                    s is not None for s in self.slots):
                self.step()
        return self._report(self.time() - t0)

    # ------------------------------------------------------- report

    def _report(self, wall: float) -> ServeReport:
        seqs = self.finished
        gen = sum(len(s.tokens) for s in seqs)
        ttft = [(s.t_first - s.t_submit) * 1e3 for s in seqs
                if s.t_first is not None]
        itl = [(b - a) * 1e3 for s in seqs
               for a, b in zip(s.token_times, s.token_times[1:])]
        grid = self.decode_steps * self.n_slots
        return ServeReport(
            requests=len(seqs),
            n_slots=self.n_slots,
            decode_steps=self.decode_steps,
            prompt_tokens=sum(len(s.prompt) for s in seqs),
            generated_tokens=gen,
            decode_slot_tokens=self.decode_slot_tokens,
            decode_time_s=self._decode_time,
            wall_time_s=wall,
            decode_tok_s=(self.decode_slot_tokens / self._decode_time
                          if self._decode_time else 0.0),
            gen_tok_s=gen / wall if wall else 0.0,
            slot_occupancy=self.decode_slot_tokens / grid if grid else 0.0,
            peak_live=self._peak_live,
            mean_live=(self._live_sum / self.decode_steps
                       if self.decode_steps else 0.0),
            preemptions=sum(s.preemptions for s in seqs),
            ttft_p50_ms=_pct(ttft, 50), ttft_p99_ms=_pct(ttft, 99),
            itl_p50_ms=_pct(itl, 50), itl_p95_ms=_pct(itl, 95),
            itl_p99_ms=_pct(itl, 99),
            cache_kind=self.cache.kind,
            device_bytes=self.cache.device_bytes,
            kv=self.cache.stats.as_dict(),
        )
