"""What the training engine does differently on a mesh (`core/engine.py`
calls it; the JAX package leaves all of it to GSPMD):

  * batch: each rank trains on its rows of the global batch, the rows of
    its linear index over the dp axes (`local_batch`); the loss is each
    rank's mean weighted by its share of the tokens (`loss_weight`), so
    the dp mean of the ranks' gradients is the global batch's;
  * parameters: a rank holds its shard of every leaf as
    `param_specs(fsdp=True)` lays it out; before a stage runs, the dims
    sharded over the dp axes are gathered (`gather_stage`), and after the
    stage's backward their gradients are reduce-scattered back to the
    shard, while the gradients of leaves replicated over dp are
    all-reduced; both are divided by the dp size (`reduce_grads`);
  * the global gradient norm of clipping sums each leaf once over the
    mesh (`sq_norm`);
  * saved tensors: a layer stage's tensors go to the spool through the
    mesh hooks (`core/hooks.py::HookBridge`) under the lease
    ``jit{step}/s{shard}``; on a tensor axis a tensor the stage saved
    outside its parallel regions (`parallel/comm.py::saved_replicated`)
    is stored as this rank's 1/tp slice along its innermost dim the axis
    divides, and gathered back on fetch (`pack` / `unpack`), so the
    ranks of the axis store it once between them, as `plan_shards`
    splits it in the JAX package.

Serving (`models/api.py`) with fsdp weights gathers a layer's leaves
just before the layer runs (`fsdp_gather`) and drops them after.

The shard id is this rank's linear index over the writer axes (the dp
axes that split the batch, and the tensor axis when the model is split
over it); the other axes only replicate, and with replica dedup their
primary replica stores for them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hooks import HookBridge, ReplicaLink, plan_shards
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.parallel.comm import save_scope, tp_group
from repro_torch.parallel.mesh import (axes_size, linear_axis_index,
                                       spec_axes)
from repro_torch.parallel.sharding import Concat, map_with_path


class LeafSpec:
    """A parameter leaf's spec as a tree leaf (a bare tuple would be a
    tree node). Indexing it drops the stacked layer dim, as `layer()`
    slices a stacked leaf."""

    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = tuple(spec)

    def __getitem__(self, i) -> "LeafSpec":
        return LeafSpec(self.spec[1:])

    def __repr__(self) -> str:
        return f"LeafSpec{self.spec}"


def wrap_specs(spec_tree):
    return map_with_path(lambda _, s: LeafSpec(s), spec_tree)


def _dp_dim(spec, dp: Tuple[str, ...]) -> Optional[int]:
    """The dim a spec shards over exactly the dp axes (fsdp), or None."""
    want = dp[0] if len(dp) == 1 else dp
    for d, entry in enumerate(spec):
        if entry == want or (isinstance(entry, tuple) and entry == dp):
            return d
    return None


def _entry_axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _narrow(leaf, d: int, start: int, size: int):
    idx = [slice(None)] * len(leaf.shape)
    idx[d] = slice(start, start + size)
    return leaf[tuple(idx)]


def _cat(parts, d: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=d)
    return np.concatenate(parts, axis=d)


def cut_leaf(leaf, spec: LeafSpec, mesh):
    """This rank's shard of one leaf (a tensor or numpy array of the
    global shape) as `spec` lays it out (a `Concat` dim part by part)."""
    for d, entry in enumerate(spec.spec):
        if entry is None:
            continue
        if isinstance(entry, Concat):
            pieces, off = [], 0
            for size, ax in entry.parts:
                part = _narrow(leaf, d, off, size)
                off += size
                if ax is not None:
                    k = size // mesh.shape[ax]
                    part = _narrow(part, d, mesh.coords[ax] * k, k)
                pieces.append(part)
            leaf = _cat(pieces, d)
            continue
        axes = _entry_axes(entry)
        size = leaf.shape[d] // axes_size(mesh, axes)
        leaf = _narrow(leaf, d, linear_axis_index(mesh, axes) * size, size)
    return leaf.contiguous() if isinstance(leaf, torch.Tensor) \
        else leaf.copy()


def shard_tree(tree, spec_tree, mesh):
    """This rank's shard of every leaf of `tree` (tensors or numpy arrays
    of the global shapes) as `spec_tree` lays them out."""
    return _zip_map(lambda leaf, spec: cut_leaf(leaf, spec, mesh), tree,
                    wrap_specs(spec_tree))


def _concat_pieces(t, d: int, entry: "Concat", mesh):
    """(piece, its part's axis) for each part of `t`'s `Concat` dim `d`,
    as this rank holds them."""
    off = 0
    for (_, ax), k in zip(entry.parts, entry.local_sizes(mesh)):
        yield t.narrow(d, off, k), ax
        off += k


def gather_leaf(shard: torch.Tensor, spec: LeafSpec, mesh) -> torch.Tensor:
    """`cut_leaf` undone: the global leaf from every rank's shard, on
    every rank (a collective over the axes of each sharded dim)."""
    for d, entry in enumerate(spec.spec):
        if isinstance(entry, Concat):
            shard = torch.cat([
                p if ax is None else
                mesh.comm.all_gather_cat(p.contiguous(), (ax,), d)
                for p, ax in _concat_pieces(shard, d, entry, mesh)], dim=d)
        elif entry is not None:
            shard = mesh.comm.all_gather_cat(shard, _entry_axes(entry), d)
    return shard


class ShardLayout:
    """A mesh session's train state as the logical arrays a checkpoint
    stores (`ckpt/checkpoint.py`, the JAX package's layout, which keeps
    global arrays and reshards on restore): on save each leaf sharded by
    its spec is gathered over the spec's axes (every rank takes part, the
    writer, rank 0, keeps the result and writes it); on restore every
    rank cuts its shard out of the logical array (`cut_leaf`). Keys are
    the checkpoint's leaf keys: `params/...` take the parameters' specs
    (`param_specs(fsdp=True)`), the moments `opt_state/.mu/...` and
    `.nu/...` the same ones (ZeRO-1,
    `parallel/sharding.py::spec_tree_for_optstate`), and any other leaf
    (the step counter) is replicated."""

    _PREFIXES = ("params/", "opt_state/.mu/", "opt_state/.nu/")

    def __init__(self, mesh, spec_tree, device):
        from repro_torch.ckpt.checkpoint import flatten_with_paths
        self.mesh, self.device = mesh, torch.device(device)
        self.writer = mesh.rank == 0
        self._specs = dict(flatten_with_paths(spec_tree))

    def spec_of(self, key: str) -> Optional[LeafSpec]:
        for pre in self._PREFIXES:
            if key.startswith(pre):
                return self._specs.get(key[len(pre):])
        return None

    def gather(self, key: str, leaf):
        """The logical leaf of `key` on the writer (None on the others).
        A moment the optimizer overlap materialized on the host goes to
        the rank's device first under NCCL, which takes no host tensor."""
        spec = self.spec_of(key)
        if spec is not None and isinstance(leaf, torch.Tensor) and any(
                e is not None for e in spec.spec):
            if self.mesh.comm.backend == "nccl" and \
                    leaf.device != self.device:
                leaf = leaf.to(self.device)
            leaf = gather_leaf(leaf, spec, self.mesh)
        return leaf if self.writer else None

    def cut(self, key: str, arr):
        """This rank's shard of the stored logical array of `key`."""
        spec = self.spec_of(key)
        return arr if spec is None else cut_leaf(arr, spec, self.mesh)

    def barrier(self) -> None:
        self.mesh.comm.barrier()


def _leaf_pieces(g, spec, mesh):
    """(piece, the axes it is sharded over) of a leaf's shard: the shard
    itself, or one piece per part of its `Concat` dim."""
    plain = set(spec_axes(tuple(e for e in spec
                                if not isinstance(e, Concat))))
    for d, entry in enumerate(spec):
        if isinstance(entry, Concat):
            for piece, ax in _concat_pieces(g, d, entry, mesh):
                yield piece, plain | ({ax} if ax else set())
            return
    yield g, plain


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, specs)


def gather_leaves(comm, dp: Tuple[str, ...], leaves, specs, groups
                  ) -> List[torch.Tensor]:
    """`leaves` with the dp-sharded dims of those in `groups` (lists of
    indices) gathered over the dp axes `dp`: the shards of a group go out
    as one message. One exchange buffer is live at a time."""
    out = list(leaves)
    for idx in groups:
        dims = [_dp_dim(specs[i].spec, dp) for i in idx]
        moved = [leaves[i].detach().movedim(d, 0) for i, d in
                 zip(idx, dims)]
        parts = comm.all_gather(torch.cat([m.reshape(-1) for m in moved]),
                                dp)
        off = 0
        for i, d, m in zip(idx, dims, moved):
            n = m.numel()
            out[i] = torch.cat([p[off:off + n].view(m.shape).movedim(0, d)
                                for p in parts], dim=d)
            off += n
        del parts
    return out


def fsdp_gather(tree, spec_tree, settings):
    """A serving weight tree (a layer's, the embedding's, the head's)
    with its dp-sharded dims gathered over `settings.dp_axes`, or `tree`
    itself when `spec_tree` is None (TP-only weights). `spec_tree`: the
    tree's `LeafSpec`s (`wrap_specs`; a stacked tree's `layer()` slice
    drops the layer dim). One message a leaf, so that a layer's gathered
    leaves and one leaf's exchange buffer are live at once, not a second
    copy of the layer; the caller drops the result after its use."""
    if spec_tree is None:
        return tree
    mesh = settings.mesh
    dp = tuple(a for a in settings.dp_axes if mesh.shape[a] > 1)
    leaves, tdef = tree_flatten(tree)
    specs = tree_flatten(spec_tree)[0]
    groups = [[i] for i, sp in enumerate(specs)
              if dp and _dp_dim(sp.spec, dp) is not None]
    return tree_unflatten(tdef, gather_leaves(mesh.comm, dp, leaves, specs,
                                              groups))


def check_mesh_config(cfg, mesh=None, axes=None) -> None:
    """Refuse a mesh whose tensor axis does not divide what a recurrent
    block splits over it: mamba2's SSM heads, the RG-LRU width
    (`models/transformer.py::check_tensor_axis`, a ValueError naming the
    shapes). Every family the port has trains on a mesh: attention
    decoders and encoders with dense or MoE MLPs, embeddings inputs
    (hubert), cross-attention over image embeddings (llama-3.2-vision),
    T5's encoder and decoder streams, mamba2 on each rank's heads and
    recurrentgemma's RG-LRU on each rank's width."""
    from repro_torch.models.transformer import check_tensor_axis
    if mesh is not None and axes is not None and axes.tp is not None:
        check_tensor_axis(cfg, mesh.shape.get(axes.tp, 1))


#: backends whose blobs may sit in one process's memory: no other rank
#: can read them
_PROCESS_LOCAL = ("mem", "tiered", "managed")

_BRIDGES = [0]


def mesh_bridge(run: "MeshRun", spool, io_config,
                offloads: bool = True) -> HookBridge:
    """The rank's mesh hooks over `spool`. With replica dedup across
    processes (and a policy that `offloads`), a `ReplicaLink` over the
    process group's store, its keys prefixed by the bridge's number
    (every rank builds its engines in the same order, so the ranks of one
    session agree on it)."""
    _BRIDGES[0] += 1
    link = None
    if offloads and io_config.dedupe_replicas and run.n_replicas > 1:
        kind = spool.backend.kind
        if kind in _PROCESS_LOCAL:
            raise ValueError(
                f"replica dedup across ranks reads the primary replica's "
                f"blobs from storage every rank sees; the {kind!r} backend "
                f"holds them in one process's memory: use fs, striped or "
                f"aio, or dedupe_replicas=False (--spool-no-dedupe)")
        link = ReplicaLink(run.comm.store(), f"hooks{_BRIDGES[0]}")
    return HookBridge(spool, dedupe_replicas=io_config.dedupe_replicas,
                      link=link)


class MeshRun:
    """One rank's share of a training step on `settings.mesh`."""

    def __init__(self, settings):
        mesh = settings.mesh
        self.mesh, self.comm = mesh, mesh.comm
        self.dp = tuple(a for a in settings.dp_axes if mesh.shape[a] > 1)
        self.dp_size = axes_size(mesh, self.dp)
        self.dp_index = linear_axis_index(mesh, self.dp)
        self.tp = tp_group(settings)
        # the parameters' spec tree (`set_specs`, before the first step)
        self.specs = None
        writer = tuple(a for a in mesh.axis_names if a in self.dp or (
            self.tp is not None and a == self.tp.axis))
        replica = tuple(a for a in mesh.axis_names if a not in writer)
        self.shard = linear_axis_index(mesh, writer)
        self.replica = linear_axis_index(mesh, replica)
        self.n_replicas = axes_size(mesh, replica)
        self.bridge: Optional[HookBridge] = None
        self._cuts: Dict[Any, List] = {}
        # the device a collective's small operands live on
        self._small = ("cpu" if self.comm.backend in ("gloo", "dry")
                       else torch.device("cuda", torch.cuda.current_device()))

    def set_specs(self, spec_tree) -> None:
        """The global parameters' specs (`param_specs(fsdp=True)`)."""
        self.specs = wrap_specs(spec_tree)

    # ------------------------------------------------------------ batch

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of every batch entry (dim 0)."""
        if self.dp_size == 1:
            return batch
        out = {}
        for k, v in batch.items():
            n = v.shape[0]
            if n % self.dp_size:
                raise ValueError(f"batch of {n} rows does not split over "
                                 f"{self.dp_size} data-parallel ranks")
            r = n // self.dp_size
            out[k] = v[self.dp_index * r:(self.dp_index + 1) * r]
        return out

    def loss_weight(self, labels: torch.Tensor) -> float:
        """This rank's tokens over the dp mean of the ranks' tokens: its
        mean loss times this, averaged over dp, is the global mean."""
        if self.dp_size == 1:
            return 1.0
        # a dry run's labels hold no values: every token counts
        mine = (float(labels.numel()) if labels.device.type == "meta"
                else float((labels >= 0).sum()))
        total = float(self.comm.all_reduce_sum(
            torch.tensor([mine], dtype=torch.float64, device=self._small),
            self.dp)[0])
        return mine * self.dp_size / total if total else 1.0

    def mean_loss(self, value: float) -> float:
        """The dp mean of the ranks' (weighted) losses."""
        if self.dp_size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self._small)
        return float(self.comm.all_reduce_sum(t, self.dp)[0]) / self.dp_size

    # ------------------------------------------------------- parameters

    def gather_stage(self, leaves: Sequence[torch.Tensor],
                     specs: Sequence[LeafSpec]) -> List[torch.Tensor]:
        """A stage's leaves with their dp-sharded dims gathered: the
        shards of one dtype go out as one message, so a stage costs one
        all-gather, not one a leaf."""
        return gather_leaves(self.comm, self.dp, leaves, specs,
                             self._fsdp_groups(leaves, specs))

    def _fsdp_groups(self, leaves, specs, fsdp: bool = True):
        """Indices of the leaves sharded over dp (`fsdp`) or not, by dtype."""
        groups: Dict[Any, List[int]] = {}
        if not self.dp:
            return []
        for i, (t, sp) in enumerate(zip(leaves, specs)):
            if (_dp_dim(sp.spec, self.dp) is not None) == fsdp:
                groups.setdefault(t.dtype, []).append(i)
        return list(groups.values())

    def reduce_grads(self, grads: Sequence[torch.Tensor],
                     specs: Sequence[LeafSpec]) -> List:
        """A stage's gradients (of its gathered leaves) back on this
        rank's shards, averaged over the dp axes: one reduce-scatter for
        the dp-sharded leaves of a dtype, one all-reduce for the rest."""
        out = list(grads)
        n = self.dp_size
        for idx in self._fsdp_groups(grads, specs):
            dims = [_dp_dim(specs[i].spec, self.dp) for i in idx]
            # row j of each leaf: the chunk of the member at index j
            rows = [grads[i].movedim(d, 0).contiguous().view(n, -1)
                    for i, d in zip(idx, dims)]
            mine = self.comm.reduce_scatter_sum(
                torch.cat(rows, dim=1).reshape(-1), self.dp, 0)
            off = 0
            for i, d, r in zip(idx, dims, rows):
                g = grads[i].movedim(d, 0)
                shape = (g.shape[0] // n,) + tuple(g.shape[1:])
                piece = mine[off:off + r.shape[1]].view(shape)
                out[i] = piece.movedim(0, d).contiguous().div_(n)
                off += r.shape[1]
        for idx in self._fsdp_groups(grads, specs, fsdp=False):
            flat = self.comm.all_reduce_sum(
                torch.cat([grads[i].reshape(-1) for i in idx]), self.dp)
            off = 0
            for i in idx:
                k = grads[i].numel()
                out[i] = flat[off:off + k].view(grads[i].shape).div_(n)
                off += k
        return out

    def sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of a tree of this rank's gradient
        shards: each leaf (each part of a `Concat` dim) counted on the
        ranks at index 0 of the axes it is replicated over, then summed
        over the mesh."""
        pairs: List = []
        _zip_map(lambda g, s: pairs.append((g, s)), grads,
                 {k: self.specs[k] for k in grads})
        total = torch.zeros((), dtype=torch.float32,
                            device=pairs[0][0].device)
        for g, spec in pairs:
            for piece, sharded in _leaf_pieces(g, spec.spec, self.mesh):
                if all(self.mesh.coords[a] == 0
                       for a in self.mesh.axis_names if a not in sharded):
                    total = total + piece.float().square().sum()
        return self.comm.all_reduce_sum(total.reshape(1),
                                        self.mesh.axis_names)[0]

    # ------------------------------------------------------ saved tensors

    def scope(self):
        """The stage forward's classification of saved tensors (a tensor
        axis only)."""
        if self.tp is None:
            return contextlib.nullcontext(None)
        return save_scope()

    def pack(self, saved: List[torch.Tensor], flags: List[bool]
             ) -> Tuple[List[torch.Tensor], List]:
        """The tensors to store: a replicated one as this rank's slice of
        its innermost dim the tensor axis divides. Returns (tensors, the
        cuts `unpack` undoes)."""
        if self.tp is None:
            return list(saved), []
        out, cuts = list(saved), []
        n, r = self.tp.size, self.tp.rank
        for i, (t, rep) in enumerate(zip(saved, flags)):
            if not rep:
                continue
            spec = plan_shards(self.mesh, (), self.tp.axis, [t.shape]).specs[0]
            if self.tp.axis not in spec:
                continue
            d = spec.index(self.tp.axis)
            size = t.shape[d] // n
            out[i] = t.narrow(d, r * size, size).contiguous()
            cuts.append((i, d, None if t.is_contiguous() else t.stride()))
        return out, cuts

    def unpack(self, fetched: List[torch.Tensor], cuts) -> List:
        """`pack` undone: each cut tensor gathered over the tensor axis,
        in the layout it was saved with."""
        out = list(fetched)
        for i, d, stride in cuts:
            whole = self.comm.all_gather_cat(out[i], self.tp.axes, d)
            if stride is not None:
                whole = torch.empty_strided(
                    whole.shape, stride, dtype=whole.dtype,
                    device=whole.device).copy_(whole)
            out[i] = whole
        return out

    def offload(self, step_key, si: int, saved, flags) -> None:
        packed, self._cuts[(step_key, si)] = self.pack(saved, flags)
        self.bridge.sharded_offload(step_key, si, packed, shard=self.shard,
                                    replica=self.replica,
                                    n_replicas=self.n_replicas)

    def fetch(self, step_key, si: int) -> List[torch.Tensor]:
        got = self.bridge.sharded_fetch(step_key, si, shard=self.shard,
                                        replica=self.replica,
                                        n_replicas=self.n_replicas)
        return self.unpack(got, self._cuts.pop((step_key, si)))

    def settle(self) -> None:
        if self.bridge is not None:
            self.bridge.settle()
