"""Meshes of ranks and their bookkeeping, after the JAX package's
`repro/parallel/shmap.py:38-95` and `repro/launch/mesh.py:39-45`.

A JAX mesh is a grid of devices that one program partitions; the port
runs one process per rank under `torch.distributed`, so a `Mesh` is the
same grid seen from one rank: its `axis_names`, its `shape` (a mapping
axis -> size, as `jax.sharding.Mesh.shape`) and this rank's coordinate
on every axis. Ranks are laid out row-major over the axes in order
(`("data", "model")` of shape (2, 2): rank = 2 * data + model), so a
model-axis group is consecutive ranks, as the GPUs of one node are.

JAX's `PartitionSpec` is replaced by a plain tuple with one entry per
dimension: None (replicated), an axis name, or a tuple of axis names.

`linear_axis_index` is the shard id JAX computes inside a `shard_map`
body (`jax.lax.axis_index` over the listed axes); here it is read off the
rank's coordinates. The shard_map shim has no counterpart, and the TPU
constants of `launch/mesh.py` are not carried over.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]

#: the axis names a mesh of 1, 2 or 3 dimensions gets on the CLI (the
#: JAX CLI's `repro/launch/train.py:166-167`)
AXIS_NAMES = {1: ("data",), 2: ("data", "model"),
              3: ("pod", "data", "model")}


class Mesh:
    """A grid of `size` ranks over named axes, seen from `rank`.

    `comm` is the `parallel.comm.Comm` that carries collectives over the
    mesh's groups (None for a mesh used only for its arithmetic, as the
    sharding rules and the tests' stub meshes are)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, comm: Any = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} do not match")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = mesh_size(self)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords: Dict[str, int] = {}
        rest = rank
        for name in reversed(axis_names):
            rest, self.coords[name] = divmod(rest, self.shape[name])
        self.comm = comm

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at `coords` (row-major over the axes)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def group_ranks(self, axes: Iterable[str]) -> Tuple[int, ...]:
        """The ranks that share this rank's coordinates on every axis but
        `axes`, ordered by their linear index over `axes`: this rank's
        group along those axes."""
        axes = tuple(axes)
        out = []
        for i in range(axes_size(self, axes)):
            coords = dict(self.coords)
            for name in reversed(axes):
                i, coords[name] = divmod(i, self.shape[name])
            out.append(self.rank_of(coords))
        return tuple(out)

    def all_groups(self, axes: Iterable[str]) -> Tuple[Tuple[int, ...], ...]:
        """Every group along `axes` (the partition of all ranks), in the
        order of the group's lowest rank: each rank creates them all, in
        this order, as `torch.distributed.new_group` needs."""
        axes = tuple(axes)
        seen, out = set(), []
        for r in range(self.size):
            g = Mesh(self.devices_shape, self.axis_names,
                     rank=r).group_ranks(axes)
            if g not in seen:
                seen.add(g)
                out.append(g)
        return tuple(out)

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in self.axis_names)
        return f"Mesh({dims} {self.axis_names}, rank {self.rank})"


def mesh_size(mesh) -> int:
    """Rank count of a mesh; 1 for None (no mesh = one device)."""
    if mesh is None:
        return 1
    n = 1
    for s in mesh.shape.values():
        n *= int(s)
    return n


def axes_size(mesh, axes: Sequence[str]) -> int:
    """Product of the listed mesh axis sizes (1 for an empty list)."""
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def linear_axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's linearised index over `axes` (row major in the listed
    order); 0 for an empty list, which callers read as 'one shard'."""
    idx = 0
    for name in axes:
        idx = idx * int(mesh.shape[name]) + int(mesh.coords[name])
    return idx


def spec_axes(spec) -> Tuple[str, ...]:
    """Mesh axis names a spec mentions, in spec order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out.append(a)
    return tuple(out)


def local_shape(global_shape: Tuple[int, ...], spec, mesh) \
        -> Tuple[int, ...]:
    """Per-shard block shape of a value sharded as `spec` on `mesh` (a
    `sharding.Concat` dim holds its pieces of each part)."""
    dims = list(global_shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        if hasattr(entry, "local_sizes"):
            dims[d] = sum(entry.local_sizes(mesh))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims[d] //= axes_size(mesh, axes)
    return tuple(dims)


def canonical_axis_entry(axes: Sequence[str]) -> Optional[Any]:
    """A spec dim entry for `axes`: None when empty, the bare name for
    one axis, else the tuple."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   rank: int = 0, comm: Any = None) -> Mesh:
    """A small mesh, as the JAX package's `launch/mesh.py::make_test_mesh`
    builds for its multi-device tests, seen from `rank`."""
    return Mesh(shape, axes, rank=rank, comm=comm)


def parse_mesh(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'2x4' -> ((2, 4), ("data", "model")), the JAX CLI's `--mesh`."""
    try:
        shape = tuple(int(d) for d in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad --mesh {text!r}; expected e.g. 2x4") from None
    if not shape or any(d < 1 for d in shape) or len(shape) > 3:
        raise ValueError(f"bad --mesh {text!r}; expected e.g. 2x4")
    return shape, AXIS_NAMES[len(shape)]


__all__ = ["AXIS_NAMES", "Mesh", "Spec", "axes_size", "canonical_axis_entry",
           "linear_axis_index", "local_shape", "make_test_mesh", "mesh_size",
           "parse_mesh", "spec_axes"]
