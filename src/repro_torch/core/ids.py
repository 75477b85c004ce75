"""Tensor identity for deduplication and parameter exclusion (paper
§3.3.1), the port's counterpart of the JAX package's `repro/core/ids.py`.

In PyTorch a saved tensor is often a *view*: `x @ w` saves `w`, and
`w.reshape(...)`, `w.t()` or the i-th slice of a stacked (L, ...) leaf
are new tensor objects over the parameter's storage. So identity is by
storage, never by `id()`:

  * a parameter is any tensor whose storage is a registered parameter's
    storage (every view of a weight is excluded from offloading);
  * a duplicate is a tensor with the same storage, offset, shape, stride
    and dtype as one already tracked *and still alive*. On the meta
    device (a dry run) a storage is told apart by its object, as every
    meta pointer is 0. The registry
    holds a weak reference to the tracked tensor, so a recycled address
    (the caching allocator reuses memory within a step) never matches a
    dead entry.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Set, Tuple

import torch

from repro_torch.core.tree import tree_flatten

Key = Tuple


def storage_ptr(t: torch.Tensor) -> int:
    """The storage's address; on the meta device, where every address is
    0, the storage object's identity (held alive with the tensor)."""
    st = t.untyped_storage()
    return id(st) if st.device.type == "meta" else st.data_ptr()


def tensor_key(t: torch.Tensor) -> Key:
    """Identity of a tensor's bytes: (device, storage pointer, offset,
    shape, stride, dtype)."""
    return (str(t.device), storage_ptr(t), t.storage_offset(),
            tuple(t.shape), t.stride(), t.dtype)


class TensorIdRegistry:
    """Parameter storages, and live tracked tensors with a refcount each.

    `acquire(t)` returns (tid, is_duplicate); every acquire is paired
    with a `release_key(tensor_key(t), tid)` when the caller's use
    ends."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        # key -> [tid, refcount, weakref to the tracked tensor]
        self._by_key: Dict[Key, list] = {}
        self._params: Set[Tuple[str, int]] = set()

    def register_parameters(self, tree) -> int:
        """Exclude every view of every leaf's storage from offloading.
        Replaces the previous registration (parameters updated out of
        place get new storages)."""
        leaves = [t for t in tree_flatten(tree)[0]
                  if isinstance(t, torch.Tensor)]
        with self._lock:
            self._params = {(str(t.device), storage_ptr(t))
                            for t in leaves}
        return len(leaves)

    def is_parameter(self, t: torch.Tensor) -> bool:
        with self._lock:
            return (str(t.device), storage_ptr(t)) in self._params

    def acquire(self, t: torch.Tensor) -> Tuple[int, bool]:
        key = tensor_key(t)
        with self._lock:
            rec = self._by_key.get(key)
            if rec is not None and rec[2]() is not None:
                rec[1] += 1
                return rec[0], True
            tid = self._next
            self._next += 1
            self._by_key[key] = [tid, 1, weakref.ref(t)]
            return tid, False

    def release_key(self, key: Key, tid: int) -> None:
        """Release one acquire of entry `tid` (a stale key whose entry
        was since replaced by a new tensor at the same address is a
        no-op)."""
        with self._lock:
            rec = self._by_key.get(key)
            if rec is None or rec[0] != tid:
                return
            rec[1] -= 1
            if rec[1] <= 0:
                del self._by_key[key]
