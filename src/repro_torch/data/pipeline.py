"""Deterministic synthetic token pipeline with sharded host loading, a
numpy-only copy of the JAX package's `repro/data/pipeline.py`, so both
packages draw the same batches from the same seed.

The paper trains on OSCAR; the data substrate here is a deterministic
synthetic corpus with real pipeline mechanics:

  * SyntheticMarkovLM — a seeded first-order Markov language over `vocab`
    tokens (Zipf-ish transition rows). It has learnable bigram structure,
    so example drivers show a genuinely decreasing loss, and it is a pure
    function of (seed, shard, step): restarting from a checkpoint
    reproduces the exact stream (fault-tolerance requirement).
  * pack_documents — EOS-separated document packing to fixed seq_len
    (the standard LM pretraining treatment).
  * ShardedLoader — host-sharded batches (host i of N gets rows
    i::N), background prefetch thread with bounded queue, and a
    state_dict()/load_state_dict() pair so the trainer checkpoints the
    data position alongside the model.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class SyntheticMarkovLM:
    """Seeded Markov chain over the vocab; deterministic per (shard, step)."""

    def __init__(self, vocab_size: int, *, seed: int = 0, branch: int = 8):
        self.vocab = vocab_size
        self.seed = seed
        self.branch = branch
        rng = np.random.default_rng(seed)
        # each token transitions to `branch` candidates with Zipf weights
        self._next = rng.integers(0, vocab_size,
                                  size=(vocab_size, branch)).astype(np.int32)
        w = 1.0 / np.arange(1, branch + 1)
        self._w = (w / w.sum()).astype(np.float64)

    def sample(self, shard: int, step: int, batch: int, seq_len: int) \
            -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, shard, step]))
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        choices = rng.choice(self.branch, size=(batch, seq_len), p=self._w)
        for t in range(seq_len):
            toks[:, t + 1] = self._next[toks[:, t], choices[:, t]]
        return toks

    def batch(self, shard: int, step: int, batch: int,
              seq_len: int) -> Dict[str, np.ndarray]:
        toks = self.sample(shard, step, batch, seq_len)
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   eos_id: int, pad_id: int = 0) -> np.ndarray:
    """Pack variable-length docs into (n, seq_len) rows, EOS-separated.

    Greedy first-fit in arrival order; a doc longer than seq_len is split.
    The final partial row is padded with pad_id."""
    rows: List[np.ndarray] = []
    cur: List[int] = []
    for doc in docs:
        toks = list(doc) + [eos_id]
        while toks:
            space = seq_len - len(cur)
            cur.extend(toks[:space])
            toks = toks[space:]
            if len(cur) == seq_len:
                rows.append(np.asarray(cur, np.int32))
                cur = []
    if cur:
        cur.extend([pad_id] * (seq_len - len(cur)))
        rows.append(np.asarray(cur, np.int32))
    return np.stack(rows) if rows else np.zeros((0, seq_len), np.int32)


@dataclass
class PackedDataset:
    """Fixed array of packed rows served batch-by-batch (eval sets)."""
    rows: np.ndarray

    def batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        n = (len(self.rows) // batch) * batch
        for i in range(0, n, batch):
            rows = self.rows[i:i + batch]
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class ShardedLoader:
    """Host-sharded, prefetching, checkpointable loader.

    Each host pulls only its shard of the global batch (host i gets
    global_batch // num_hosts rows); `state_dict()` captures the step
    cursor so restarts resume the exact stream.
    """

    def __init__(self, source: SyntheticMarkovLM, *, global_batch: int,
                 seq_len: int, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of num_hosts {num_hosts}")
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._step = start_step
        self._prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if prefetch > 0:
            self._start_worker()

    def _start_worker(self) -> None:
        """A prefetch thread producing batches from the cursor on."""
        self._q = queue.Queue(maxsize=max(self._prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._step, self._stop, self._q),
            daemon=True)
        self._thread.start()

    def _stop_worker(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        return self.source.batch(self.host_id, step, self.local_batch,
                                 self.seq_len)

    def _worker(self, step: int, stop: threading.Event,
                q: "queue.Queue") -> None:
        while not stop.is_set():
            batch = self._make(step)
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            batch = self._make(self._step)
            self._step += 1
            return batch
        while True:
            step, batch = self._q.get()
            if step < self._step:      # stale after load_state_dict
                continue
            self._step = step + 1
            return batch

    def state_dict(self) -> Dict:
        return {"step": self._step, "host_id": self.host_id,
                "num_hosts": self.num_hosts}

    def load_state_dict(self, state: Dict) -> None:
        # note: resharding to a different host count is allowed — the
        # stream is a pure function of (shard, step), so elastically
        # resized restarts stay deterministic per shard.
        self._step = int(state["step"])
        if self._thread is not None:
            # the prefetch thread runs ahead of the cursor: a cursor moved
            # back would be served the thread's next batch, not its own,
            # so the thread restarts at the cursor
            self._stop_worker()
            self._start_worker()

    def close(self):
        self._stop_worker()


def encoder_decoder_batches(vocab_size: int, *, batch: int, seq_len: int,
                            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The session's synthetic batches (`SyntheticMarkovLM` through
    `ShardedLoader`, without a prefetch thread) for an encoder-decoder:
    the encoder reads the decoder's own tokens (`enc_tokens = tokens`),
    as the JAX package's `benchmarks/common.py` feeds T5."""
    loader = ShardedLoader(SyntheticMarkovLM(vocab_size, seed=seed),
                           global_batch=batch, seq_len=seq_len, prefetch=0)
    for b in loader:
        yield dict(b, enc_tokens=b["tokens"])
