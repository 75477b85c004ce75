"""Atomic, async checkpoints of the port, in the JAX package's layout
(`repro/ckpt/checkpoint.py`), so either package restores the other's.

Layout per step:
    <dir>/step_<N:08d>.tmp/...      (written)
    <dir>/step_<N:08d>/             (atomic rename on commit)
        manifest.json               step, shapes, dtypes, user metadata
        arrays.npz                  flattened leaves keyed by path

Leaf keys are the JAX package's strings: dict keys in sorted order, list
and tuple indices as plain integers, NamedTuple fields (the optimizer's
`OptState`) as `.step`, `.mu`, `.nu`, joined with `/`; `None` is no
leaf. npz member names use `|` in place of `/`. bfloat16 leaves are
stored as their uint16 bit pattern with `"dtype": "bfloat16"` in the
manifest (neither jax nor ml_dtypes is needed). A Python int leaf (the
port's `OptState.step`) is stored as an int32 0-d array, as the JAX
package's step counter is, and restores as an int.

  * atomic commit: the payload is fsynced, the manifest written last,
    the directory fsynced and `os.replace`d into place; a crash leaves
    either the old committed step or a partial dir that
    `checkpoint_is_valid` rejects;
  * async save: the port's optimizer updates parameters in place, so
    `CheckpointManager.save` copies every leaf to the host before it
    returns (the step boundary's snapshot); only serialization and the
    write run on the background thread, and `wait()` joins it before
    the next save;
  * keep_last GC after each commit;
  * restore onto a device (`device=`), or in place into existing
    tensors (`in_place=True`, the train state's restore: no second copy
    of the model); sharded restore waits for the multi-GPU slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import array_to_tensor

# (leaf key, host array as stored, manifest dtype)
HostItem = Tuple[str, np.ndarray, str]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(tree):
    """((path part, child), ...) of a container in jax.tree order, or
    None for a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs with the JAX package's key strings."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in kids:
        out += flatten_with_paths(child, prefix + (part,))
    return out


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf, as stored, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    if isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, (int, np.integer)):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def host_snapshot(tree) -> List[HostItem]:
    """Host copies of every leaf of `tree`, taken now."""
    out = []
    for key, leaf in flatten_with_paths(tree):
        arr, dtype = _host_array(leaf)
        out.append((key, arr, dtype))
    return out


def _write(directory: str, step: int, items: List[HostItem],
           metadata: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    arrays = {}
    for key, arr, dtype in items:
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[key.replace("/", "|")] = arr     # zip-safe member names
    # every payload byte is fsynced before the manifest is written, the
    # manifest is written last, and the rename is made durable by
    # fsyncing the parent
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic commit
    _fsync_dir(directory)
    return final


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[Dict] = None) -> str:
    """Synchronous atomic save. Returns the committed path."""
    return _write(directory, step, host_snapshot(tree), metadata)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass                        # some filesystems reject dir fsync
    finally:
        os.close(fd)


def checkpoint_is_valid(path: str) -> bool:
    """True iff the committed checkpoint dir at `path` is complete: the
    manifest parses and the npz opens with every manifest leaf present."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            names = set(data.files)
        need = {k.replace("/", "|") for k in manifest["leaves"]}
        return need <= names
    except Exception:
        return False


def _committed_steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    """Newest step whose checkpoint is complete; partial or corrupt dirs
    are skipped with a warning."""
    if not os.path.isdir(directory):
        return None
    for s in reversed(_committed_steps(directory)):
        path = os.path.join(directory, f"step_{s:08d}")
        if checkpoint_is_valid(path):
            return s
        warnings.warn(f"skipping partial/corrupt checkpoint {path}")
    return None


def _leaf_from(arr: np.ndarray, dtype: str, like, device, in_place):
    if isinstance(like, torch.Tensor):
        host = (array_to_tensor(arr.view(np.int16)).view(torch.bfloat16)
                if dtype == "bfloat16" else array_to_tensor(arr))
        if not in_place:
            return host.to(device or like.device)
        if host.dtype != like.dtype:
            raise ValueError(f"dtype mismatch: ckpt {host.dtype} vs "
                             f"model {like.dtype}")
        with torch.no_grad():
            return like.copy_(host)
    if isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(arr)
    return arr


def _rebuild(like, prefix, restored: Dict[str, Any]):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return restored["/".join(prefix)]
    vals = [_rebuild(child, prefix + (part,), restored)
            for part, child in kids]
    if _is_namedtuple(like):
        return type(like)(*vals)
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    return type(like)(vals)


def restore_checkpoint(directory: str, tree_like, *,
                       step: Optional[int] = None, device=None,
                       in_place: bool = False):
    """Restore into the structure of `tree_like` (tensors, ints or
    arrays). Tensor leaves land on `device` (default: the like-leaf's
    device) with the stored dtype; with `in_place`, they are copied into
    the like-leaves themselves (no second copy on their device; the
    dtypes must match). A missing leaf raises KeyError, a shape or dtype
    mismatch ValueError. Returns (tree, manifest)."""
    if in_place and device is not None:
        raise ValueError("in_place restores onto the leaves' own devices")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if os.path.isdir(path) and not checkpoint_is_valid(path):
        raise ValueError(f"checkpoint {path} is partial or corrupt")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, like in flatten_with_paths(tree_like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key.replace("/", "|")]
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                    f"model {shape}")
            restored[key] = _leaf_from(arr, meta["dtype"], like, device,
                                       in_place)
            del arr
    return _rebuild(tree_like, (), restored), manifest


class CheckpointManager:
    """Async save + GC + restore with a stable directory layout.
    `last_snapshot_s` / `last_write_s` are the latest save's host
    snapshot time (on the caller's thread) and write time (on the
    background thread, known after `wait()`); `last_restore_s` the
    latest restore's time."""

    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self.last_snapshot_s = 0.0
        self.last_write_s = 0.0
        self.last_restore_s = 0.0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, metadata: Optional[Dict] = None):
        # the host copy is taken here, at the step boundary: the next
        # step updates the parameters in place
        self.wait()
        t0 = time.perf_counter()
        items = host_snapshot(tree)
        self.last_snapshot_s = time.perf_counter() - t0
        self._thread = threading.Thread(
            target=self._save_worker, args=(step, items, metadata),
            daemon=True, name="ckpt-save")
        self._thread.start()

    def _save_worker(self, step, items, metadata):
        try:
            t0 = time.perf_counter()
            _write(self.dir, step, items, metadata)
            self.last_write_s = time.perf_counter() - t0
            self._gc()
        except Exception as e:      # surfaced on the next wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = _committed_steps(self.dir)
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, tree_like, *, step=None, device=None,
                in_place=False):
        self.wait()
        t0 = time.perf_counter()
        out = restore_checkpoint(self.dir, tree_like, step=step,
                                 device=device, in_place=in_place)
        self.last_restore_s = time.perf_counter() - t0
        return out


# ------------------------------------------------- train-state helpers

def save_train_state(ckpt: CheckpointManager, step: int, params, opt_state,
                     loader=None, *, final: bool = False) -> None:
    """The one training-checkpoint layout (params + optimizer state +
    data cursor), shared by TrainLoop and TrainSession."""
    meta = {"data": loader.state_dict()
            if hasattr(loader, "state_dict") else {},
            "final": final}
    ckpt.save(step, {"params": params, "opt_state": opt_state},
              metadata=meta)
    if final:
        ckpt.wait()


def restore_train_state(ckpt: CheckpointManager, params, opt_state,
                        loader=None):
    """Restore the latest committed train-state checkpoint (the inverse
    of `save_train_state`) in place: its tensors are copied into those
    of `params` / `opt_state`, so a resumed run holds one copy of the
    model. Returns (step, params, opt_state), or None when there is
    none."""
    step = ckpt.latest_step()
    if step is None:
        return None
    restored, manifest = ckpt.restore(
        {"params": params, "opt_state": opt_state}, step=step,
        in_place=True)
    if hasattr(loader, "load_state_dict") and \
            manifest["metadata"].get("data"):
        loader.load_state_dict(manifest["metadata"]["data"])
    return step, restored["params"], restored["opt_state"]


__all__ = ["CheckpointManager", "checkpoint_is_valid", "flatten_with_paths",
           "host_snapshot", "latest_step", "restore_checkpoint",
           "restore_train_state", "save_checkpoint", "save_train_state"]
