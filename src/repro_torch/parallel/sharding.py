"""Sharding rules: spec trees for parameters, optimizer state, batches and
decode caches, per architecture, a copy of the JAX package's
`repro/parallel/sharding.py` (its rules are name + shape only).

Layout (production mesh ("pod",)"data","model"):
  * batch / activations   — dim 0 (batch) over the dp axes ("pod","data");
  * weights               — Megatron TP over "model" (q heads, d_ff, vocab,
    experts) + ZeRO-3/FSDP over "data" on the non-TP contraction dim
    (ZeRO-1 falls out: moments inherit the parameter specs);
  * kv heads / odd dims   — over "model" only when divisible (qwen kv=2,
    rg-lru kv=1 stay replicated; gemma2 kv=16 shards);
  * decode caches         — batch over dp when divisible
    (`cache_layout_specs`: the port's, a rank's share of each block).

A spec is a tuple with one entry per dimension: None, an axis name or a
tuple of axis names (`parallel/mesh.py`). Trees are the port's nested
dicts and lists; a leaf is anything with a `.shape`.

`layout_specs` is the port's own layout of the parameters on a mesh:
`param_specs`, except for mamba2's concatenated leaves, whose dims a
`Concat` entry lays out part by part (GSPMD may split them anywhere and
reshard after; the port's blocks read each part in place).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.parallel.mesh import Spec


@dataclass(frozen=True)
class MeshAxes:
    """Logical roles of mesh axes. dp: batch+fsdp axes; tp: tensor axis
    (None: no tensor parallelism, every other axis only replicates)."""
    dp: Tuple[str, ...] = ("data",)
    tp: Optional[str] = "model"

    def dp_size(self, mesh) -> int:
        n = 1
        for a in self.dp:
            n *= mesh.shape[a]
        return n

    def tp_size(self, mesh) -> int:
        return mesh.shape[self.tp] if self.tp is not None else 1


def default_axes(mesh) -> MeshAxes:
    """The roles a session gives a mesh without `mesh_axes`: every axis
    but "model" is dp, "model" (when there) is tp."""
    return MeshAxes(dp=tuple(a for a in mesh.axis_names if a != "model"),
                    tp="model" if "model" in mesh.axis_names else None)


@dataclass(frozen=True)
class Concat:
    """A spec entry for a dim that concatenates parts: each part (size,
    axis) is split over `axis`, or whole on every rank (axis None), and a
    rank's shard of the dim is its piece of each part, in order."""
    parts: Tuple[Tuple[int, Optional[str]], ...]

    def local_sizes(self, mesh) -> Tuple[int, ...]:
        return tuple(size // (mesh.shape[ax] if ax else 1)
                     for size, ax in self.parts)


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _axis_if(dim: int, axis, mesh) -> Optional[Any]:
    """axis (str or tuple) if it divides dim, else None (replicated)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        if not axis:
            return None
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        if not _div(dim, n):
            return None
        return axis[0] if len(axis) == 1 else axis
    return axis if _div(dim, mesh.shape[axis]) else None


def _rule(names: Tuple[str, ...], shape: Tuple[int, ...], mesh,
          axes: MeshAxes, fsdp: bool) -> Spec:
    """The spec of one parameter leaf, identified by its key path."""
    name = names[-1]
    layered = "segments" in names or "enc_segments" in names
    lead: Tuple = (None,) if layered else ()
    body = shape[1:] if layered else shape
    tp, dpx = axes.tp, (axes.dp if fsdp else None)

    def spec(*parts):
        return tuple(lead + parts)

    # ---- scalars / vectors that stay replicated
    if name in ("scale", "b_a", "b_i", "lambda_p", "dt_bias", "A_log",
                "D_skip", "b"):
        return spec(*([None] * len(body)))
    if name == "norm_scale":                        # (I,) — tp if divisible
        return spec(_axis_if(body[0], tp, mesh))

    in_moe = "moe" in names
    in_conv = "conv" in names

    if in_conv and name == "w":                     # (width, C)
        return spec(None, _axis_if(body[1], tp, mesh))

    if name == "embed":                             # (V, D) vocab-sharded
        return spec(_axis_if(body[0], tp, mesh), None)
    if name == "pos_embed":                         # (Pmax, D)
        return spec(None, _axis_if(body[1], tp, mesh))
    if name == "unembed":                           # (D, V)
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh))
    if name == "frontend_proj":                     # (D, D)
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh))

    if name == "wq":                                # (D, H, hd)
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh), None)
    if name in ("wk", "wv"):                        # (D, KV, hd)
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh), None)
    if name == "wo":                                # (H, hd, D)
        return spec(_axis_if(body[0], tp, mesh), None,
                    _axis_if(body[2], dpx, mesh))
    if name in ("bq", "bk", "bv"):                  # (H, hd)
        return spec(_axis_if(body[0], tp, mesh), None)

    if in_moe:
        if name == "router":                        # (D, E)
            return spec(_axis_if(body[0], dpx, mesh), None)
        if name in ("w_in", "w_gate"):              # (E, D, F) — EP over tp
            return spec(_axis_if(body[0], tp, mesh),
                        _axis_if(body[1], dpx, mesh), None)
        if name == "w_out":                         # (E, F, D)
            return spec(_axis_if(body[0], tp, mesh), None,
                        _axis_if(body[2], dpx, mesh))

    if name in ("w_in", "w_gate", "w_zx", "w_bc", "w_branch_gate"):
        # (D, F)-shaped input projections: contract dim fsdp, out dim tp
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh))
    if name == "w_dt":                              # (D, H) H rarely divides
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh))
    if name in ("w_a", "w_i"):                      # (W, W)
        return spec(_axis_if(body[0], dpx, mesh),
                    _axis_if(body[1], tp, mesh))
    if name == "w_out":                             # (F, D)
        return spec(_axis_if(body[0], tp, mesh),
                    _axis_if(body[1], dpx, mesh))

    # fallback: replicate
    return spec(*([None] * len(body)))


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """fn(path, leaf) over nested dicts / lists / tuples; the path holds
    dict keys and list indices as strings, as JAX's key paths name them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        out = [map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _is_spec(x) -> bool:
    """A spec tuple (not a container of subtrees)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, Concat))
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def param_specs(cfg, params_shapes, mesh, axes: MeshAxes, *,
                fsdp: bool = True):
    """A spec tree matching a params tree (of tensors, arrays or anything
    with `.shape`). fsdp=False keeps weights TP-only (serving)."""
    del cfg                          # the rules read names and shapes only
    return map_with_path(
        lambda path, leaf: _rule(path, tuple(leaf.shape), mesh, axes, fsdp),
        params_shapes)


def layout_specs(cfg, params_shapes, mesh, axes: MeshAxes, *,
                 fsdp: bool = True):
    """The port's layout of a params tree on `mesh`: `param_specs`, but on
    a tensor axis of more than one rank mamba2's leaves are laid out by
    heads, since a split of the whole dim cuts across their parts:
    `w_zx` (D, 2 d_inner), z then x, has each part's columns split, so a
    rank holds z and x of its own heads; the conv weight (width, d_inner +
    2 N), channels x | B | C, has its x channels split and B | C whole;
    `w_bc` (D, 2 N) is whole, since every head reads B and C (their
    gradient is summed over the axis, `models/mamba2.py`). A checkpoint
    still holds the logical arrays (`core/meshrun.py::cut_leaf`,
    `gather_leaf`)."""
    specs = param_specs(cfg, params_shapes, mesh, axes, fsdp=fsdp)
    if axes.tp is None or mesh.shape.get(axes.tp, 1) <= 1 \
            or not cfg.ssm_state_dim:
        return specs
    d_inner, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim

    def one(path, spec):
        if "ssm" not in path:
            return spec
        lead, last = spec[:-1], None
        if path[-1] == "w_zx":
            last = Concat(((d_inner, axes.tp), (d_inner, axes.tp)))
        elif path[-1] == "w" and path[-2] == "conv":
            last = Concat(((d_inner, axes.tp), (2 * n, None)))
        elif path[-1] != "w_bc":
            return spec
        return lead + (last,)

    return map_with_path(one, specs)


def batch_specs(batch_shapes, mesh, axes: MeshAxes):
    """Shard dim 0 (global batch) over dp where divisible; scalars and
    indivisible batches replicate."""

    def one(_, leaf):
        if not leaf.shape:
            return ()
        ax = _axis_if(leaf.shape[0], axes.dp, mesh)
        return (ax,) + (None,) * (len(leaf.shape) - 1)

    return map_with_path(one, batch_shapes)


def cache_specs(cache_shapes, mesh, axes: MeshAxes):
    """Decode caches are (L, B, ...): batch over dp, kv heads over tp when
    divisible (dim 3 of attention caches)."""

    def one(_, leaf):
        nd = len(leaf.shape)
        parts = [None] * nd
        if nd >= 2:
            parts[1] = _axis_if(leaf.shape[1], axes.dp, mesh)
        if nd == 5:  # (L, B, S, KV, hd) attention cache
            parts[3] = _axis_if(leaf.shape[3], axes.tp, mesh)
        return tuple(parts)

    return map_with_path(one, cache_shapes)


def cache_layout_specs(cache_shapes, mesh, axes: MeshAxes):
    """The port's layout of a decode cache on `mesh` (the global shapes
    of `init_cache`: per segment {f"b{i}": entry}, leaves (L, B, ...)):
    the rows over the dp axes where they divide, and what a rank's block
    decodes over the tensor axis: K/V (L, B, S, KV, hd) by kv heads where
    the axis divides them, else whole on every rank (`cache_specs`'
    replication); the RG-LRU conv window (L, B, K-1, W) and state
    (L, B, W) by the width; the SSM state (L, B, H, P, N) by heads and
    its conv window (L, B, K-1, x | B | C) by part, the rank's x channels
    beside the whole B | C (`layout_specs`' conv weight). JAX's
    `cache_specs` keeps the recurrent caches whole over the tensor axis;
    the port's blocks decode a rank's share of them. `core/meshrun.py::
    cut_leaf` / `gather_leaf` cut and gather a cache by these specs."""
    tp = axes.tp

    def rows(leaf):
        return _axis_if(leaf.shape[1], axes.dp, mesh)

    def entry(e):
        if "state" in e:                                   # ssm
            n, c = e["state"].shape[-1], e["conv"].shape[-1]
            return {
                "conv": (None, rows(e["conv"]), None,
                         Concat(((c - 2 * n, tp), (2 * n, None)))
                         if _axis_if(e["state"].shape[2], tp, mesh)
                         else None),
                "state": (None, rows(e["state"]),
                          _axis_if(e["state"].shape[2], tp, mesh), None,
                          None)}
        if "h" in e:                                       # rglru
            w = _axis_if(e["h"].shape[-1], tp, mesh)
            return {"conv": (None, rows(e["conv"]), None, w),
                    "h": (None, rows(e["h"]), w)}
        kv = _axis_if(e["k"].shape[3], tp, mesh)           # attn, cross
        return {k: (None, rows(e[k]), None, kv, None) for k in ("k", "v")}

    return [{bid: entry(e) for bid, e in seg.items()}
            for seg in cache_shapes]


def spec_tree_for_optstate(param_spec_tree, opt_shapes):
    """Optimizer state specs: step replicated; moments inherit the
    parameter specs (=> ZeRO: moments are dp+tp sharded exactly like the
    weights)."""
    from repro_torch.optim.optimizers import OptState

    mu = opt_shapes.mu and param_spec_tree
    nu = opt_shapes.nu and param_spec_tree
    return OptState(step=(), mu=mu, nu=nu)


__all__ = ["Concat", "MeshAxes", "batch_specs", "cache_layout_specs",
           "cache_specs",
           "default_axes", "layout_specs", "map_with_path", "param_specs",
           "spec_tree_for_optstate"]
