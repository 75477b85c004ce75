"""Tensor-list <-> bytes serialization of spooled blobs, the JAX
package's RSA2 format (`repro/io/serde.py`):

    RSA2 | u32 header_len | pickled [(shape, dtype name), ...] | raw buffers

Blobs are readable by both packages in both directions. numpy has no
bfloat16, so a bfloat16 tensor is written with dtype name "bfloat16" and
its uint16 bit pattern as payload — exactly the bytes the JAX package
writes for an ml_dtypes bfloat16 array — and "bfloat16" is read back as
uint16 bits viewed as `torch.bfloat16`. Leaves may be CPU tensors or
numpy arrays; they are always read back as CPU tensors.
"""
from __future__ import annotations

import math
import pickle
import struct
from typing import List, Sequence

import numpy as np
import torch

_MAGIC = b"RSA2"


def _as_numpy(x):
    """(contiguous numpy array of the payload, dtype name for the header)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    # reshape back: ascontiguousarray promotes 0-d to 1-d
    x = np.ascontiguousarray(x).reshape(x.shape)
    return x, str(x.dtype)


def serialize_parts(leaves: Sequence) -> List:
    """The blob as a list of bytes-like parts, array buffers exposed as
    memoryviews (no payload copy)."""
    arrs = [_as_numpy(x) for x in leaves]
    metas = [(tuple(a.shape), name) for a, name in arrs]
    header = pickle.dumps(metas, protocol=4)
    parts: List = [_MAGIC, struct.pack("<I", len(header)), header]
    parts += [a.reshape(-1).view(np.uint8).data for a, _ in arrs]
    return parts


def serialize_leaves(leaves: Sequence) -> bytes:
    return b"".join(serialize_parts(leaves))


def deserialize_leaves(data) -> List[torch.Tensor]:
    """bytes-like -> list of CPU tensors, each owning fresh memory."""
    view = data if isinstance(data, memoryview) else memoryview(data)
    if view.itemsize != 1 or view.ndim != 1:
        view = view.cast("B")
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("not an RSA2 blob")
    (hlen,) = struct.unpack_from("<I", view, 4)
    off = 8
    metas = pickle.loads(bytes(view[off:off + hlen]))
    off += hlen
    out = []
    for shape, name in metas:
        bf16 = name == "bfloat16"
        np_dt = np.dtype(np.int16 if bf16 else name)
        n = np_dt.itemsize * math.prod(shape)
        seg = view[off:off + n]
        if len(seg) < n:
            raise ValueError(f"truncated blob: leaf {shape}/{name} needs "
                             f"{n} bytes, {len(seg)} left")
        arr = (np.frombuffer(seg, dtype=np_dt).reshape(shape).copy() if n
               else np.empty(shape, dtype=np_dt))
        t = torch.from_numpy(arr)
        out.append(t.view(torch.bfloat16) if bf16 else t)
        off += n
    return out
