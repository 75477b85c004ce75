"""Weight conversion from the JAX package's parameter tree.

`params_from_jax` takes the JAX params as numpy arrays (the caller runs
`jax.tree.map(np.asarray, params)`) and returns the port's params, key
for key, as tensors; `shard_params_from_jax` returns one mesh rank's
shard of them. bfloat16 arrays (numpy dtype name "bfloat16", from
ml_dtypes) are read through their uint16 bit pattern, so neither jax nor
ml_dtypes is imported here.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import dtype_of


def array_to_tensor(arr) -> torch.Tensor:
    """numpy array (any float dtype, bfloat16 included) -> CPU tensor
    with the same bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: Any, *, device, dtype: Optional[str] = None):
    """Nested dicts / lists of numpy arrays -> the same structure of
    tensors on `device` (cast to `dtype` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device, dtype=dtype)
                for v in tree]
    t = array_to_tensor(tree)
    if dtype is not None:
        t = t.to(dtype_of(dtype))
    return t.to(device)


def shard_params_from_jax(tree: Any, spec_tree: Any, mesh, *, device,
                          dtype: Optional[str] = None):
    """One rank's shard of the JAX package's numpy parameters: every leaf
    cut by its spec (`parallel/sharding.py::param_specs`) at the rank's
    coordinates on `mesh`, then carried over as `params_from_jax` does."""
    from repro_torch.core.meshrun import shard_tree
    return params_from_jax(shard_tree(tree, spec_tree, mesh), device=device,
                           dtype=dtype)
