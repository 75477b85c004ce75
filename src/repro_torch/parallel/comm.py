"""Collectives over a mesh, and the autograd Functions that make GSPMD's
implicit layout explicit (the JAX package partitions one program; the
port runs one process per rank and moves the data itself).

`Comm` owns one `torch.distributed` group per set of mesh axes and the
collectives the port needs, each in a fixed order so that two runs, and
every member of a group, get the same bits:

  * `all_reduce_sum` / `reduce_scatter_sum` send each member its chunk
    (`all_to_all`), and each member sums the chunks in the group's rank
    order; `all_reduce_max` and `all_gather_cat` gather, then reduce or
    concatenate in that order;
  * the backend rule (`backend_rule`): NCCL when every rank of the node
    has a GPU of its own; gloo when ranks share a card, or on the CPU.
    gloo gets no CUDA tensor: the port copies each operand through
    pinned host memory and back, and counts those bytes
    (`host_staged_bytes`, the metrics' `comm_host_staged_bytes`).

The Functions a tensor-parallel block runs (Megatron's pair, on the
"model" axis):

  * `TpGroup.enter(x)`: identity forward, all-reduce of the gradient in
    backward; the input of the column-parallel `wq/wk/wv/w_in/w_gate`
    (and of the vocab-parallel head);
  * `TpGroup.reduce(y)`: all-reduce forward, identity backward; the
    output of the row-parallel `wo/w_out` and of the vocab-parallel
    embedding lookup;
  * `TpGroup.grad_sum(*ws)`: identity forward, all-reduce of the
    gradients (one message for all of `ws`) backward; values replicated
    over the axis but used inside the parallel region (kv projections
    whose heads the axis does not divide, a recurrent block's biases and
    decays that each rank reads a slice of);
  * `TpGroup.gather(t, dim)`: all-gather forward, this rank's slice of
    the (replicated) gradient backward; `pos_embed`, whose model width
    the axis splits;
  * `TpGroup.gather_partial(t, dim)`: all-gather forward, reduce-scatter
    of the gradient backward: the whole of a split value for a parallel
    region whose downstream differs across the axis (the RG-LRU gates,
    column-parallel products of the whole width);
  * `TpGroup.sum(t)`: all-reduce forward and backward: a value every
    rank's outputs read (the sum of squares of mamba2's gated norm over
    the whole inner width);
  * `TpGroup.all_gather(t, dim)`: all-gather with no backward, for
    serving: the logits' vocab columns (a prefill or decode step returns
    the whole logits on every rank, as GSPMD's output is logically
    whole) and the RG-LRU gates' input at decode;
  * `vocab_parallel_ce`: the mean cross-entropy over a vocab split across
    the axis (global max, sum of exponentials and picked logit by
    all-reduce);
  * `sum_over(t, comm, axes)`: all-reduce forward, identity backward,
    over any axes; the MoE router's dp-global statistics
    (`models/moe.py::_route`).

Point to point (`Comm.send` / `Comm.recv`, one axis, the peer named by
its index on that axis) and `Comm.broadcast` carry the pipeline's
activations (`parallel/pipeline.py`): host-staged under gloo, direct
under NCCL.

Which saved tensors are identical across the axis: a stage's forward
runs inside `save_scope()`. Between `reduce` (and the stage's start)
and the next `enter` every value is replicated across the axis; `enter`
also marks its input's storage as replicated, since the column-parallel
products save it. `saved_replicated(t)` answers for the pack hook, and
the engine stores a replicated tensor as a 1/tp slice per rank.

Every collective counts itself once, whatever its transport does (gloo's
`CHANNELS` pieces, an all-reduce's reduce-scatter and all-gather):
`Comm.ops` holds, per op and group size, the calls and the result bytes,
so the count is the same under any backend, and the active op counter
(`launch/op_stats.py`) gets the same report, the transport's own tensor
work left uncounted. `DryComm` builds no process group: each collective
returns a tensor of its result's shape (on the meta device, one that
holds nothing) and counts what `Comm` would; the dry run
(`launch/dryrun.py`) sees a production mesh from one rank through it.
No module of the port calls `torch.distributed` but this one.

At serving (`models/api.py`) fsdp weights are gathered a layer at a
time before the layer runs, one `all_gather` over the dp axes a leaf
(`core/meshrun.py::fsdp_gather`), and dropped after.

The fsdp gather of a leaf's "data"-sharded dim before a stage runs and
the reduce-scatter of its gradient after the stage's backward are
`all_gather_cat` and `reduce_scatter_sum` over the dp axes, which the
engine calls (`core/engine.py`); the dp mean of a replicated leaf's
gradient is `all_reduce_sum` over them, divided by their size.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from itertools import combinations
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.ids import storage_ptr
from repro_torch.launch.op_stats import report_collective, uncounted
from repro_torch.parallel.mesh import Mesh, axes_size, parse_mesh


#: parallel groups per set of axes under gloo, and the least bytes a
#: piece of a message carries
CHANNELS = 4
MIN_PIECE = 1 << 20


def backend_rule(device: str, local_world: int,
                 n_gpus: int) -> Tuple[str, bool, str]:
    """(backend, host_staged, why) for ranks on `device` ("cpu" / "cuda"),
    `local_world` of them on this node, which has `n_gpus` cards."""
    if device == "cpu":
        return "gloo", False, "CPU ranks"
    if n_gpus >= local_world:
        return "nccl", False, (f"{local_world} ranks, each with a GPU of "
                               f"its own")
    return "gloo", True, (
        f"{local_world} ranks share {n_gpus} GPU(s), which NCCL refuses "
        f"(one rank per device); CUDA tensors go through pinned host "
        f"memory")


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "-1")) if "LOCAL_RANK" in \
        os.environ else torch.distributed.get_rank()


def rank_device(device: str) -> str:
    """The device a rank runs on: its own card when the node has one per
    rank, else the cards round robin (two ranks share cuda:0 on a
    one-card machine)."""
    if device == "cpu":
        return "cpu"
    n = torch.cuda.device_count()
    return f"cuda:{_local_rank() % max(n, 1)}"


class Comm:
    """Collectives over the groups of one mesh, from one rank. Build it
    with `init_mesh` (or directly over an initialised default group)."""

    def __init__(self, mesh: Mesh, *, host_staged: bool = False,
                 backend: Optional[str] = None, why: str = ""):
        import torch.distributed as dist
        self._setup(mesh, backend or str(dist.get_backend()), host_staged,
                    why)
        # gloo moves one message per connection at a time: a large
        # message goes out in pieces over CHANNELS groups of the same
        # ranks at once (PERF.md §6: chip_smoke.py phase 15's time)
        self.channels = CHANNELS if self.backend == "gloo" else 1
        self._groups: Dict[Tuple[str, ...], List[Any]] = {}
        # every subset of the axes, in a fixed order, on every rank:
        # new_group is collective over the whole world
        names = mesh.axis_names
        for k in range(1, len(names) + 1):
            for axes in combinations(names, k):
                mine = None
                for ranks in mesh.all_groups(axes):
                    if len(ranks) == 1:
                        continue
                    gs = [dist.new_group(list(ranks))
                          for _ in range(self.channels)]
                    if mesh.rank in ranks:
                        mine = gs
                self._groups[axes] = mine
        mesh.comm = self

    def _setup(self, mesh, backend, host_staged, why) -> None:
        self.mesh = mesh
        self.backend = backend
        self.host_staged = host_staged
        self.why = why
        #: bytes copied between the card and pinned host memory because
        #: the backend takes no CUDA tensor (each direction counted)
        self.host_staged_bytes = 0
        #: host seconds inside collectives: copying into pinned host
        #: memory ("stage"), waiting for the backend ("wait"), the whole
        #: call ("total")
        self.seconds = {"stage": 0.0, "wait": 0.0, "total": 0.0}
        #: "op@group size" -> [calls, result bytes], each logical
        #: collective once
        self.ops: Dict[str, List[int]] = {}
        self._tls = threading.local()

    # ----------------------------------------------------------- counts

    @contextlib.contextmanager
    def _op(self):
        """A collective's body: yields whether it is the outermost one
        (an all-reduce's reduce-scatter and all-gather are its own), its
        tensor work left out of the active op counter."""
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        try:
            with uncounted():
                yield depth == 0
        finally:
            self._tls.depth = depth

    def _record(self, op: str, result, n: int) -> None:
        if n <= 1:
            return
        ts = [t for t in (result if isinstance(result, (list, tuple))
                          else [result]) if isinstance(t, torch.Tensor)]
        rec = self.ops.setdefault(f"{op}@{n}", [0, 0])
        rec[0] += 1
        rec[1] += sum(t.numel() * t.element_size() for t in ts)
        report_collective(op, ts, n)

    def op_counts(self) -> Dict[str, List[int]]:
        """A copy of `ops`."""
        return {k: list(v) for k, v in self.ops.items()}

    def store(self):
        """The default process group's key-value store."""
        import torch.distributed as dist
        return dist.distributed_c10d._get_default_store()

    # ----------------------------------------------------------- groups

    def _canon(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = tuple(a for a in axes if self.mesh.shape[a] > 1)
        return tuple(sorted(axes, key=self.mesh.axis_names.index))

    def size(self, axes: Sequence[str]) -> int:
        return axes_size(self.mesh, axes)

    def _group(self, axes):
        """(the groups' channels, members in this call's order, the
        members' positions in the groups' rank order) or None for one
        member."""
        axes = tuple(a for a in axes if self.mesh.shape[a] > 1)
        if not axes:
            return None
        pgs = self._groups[self._canon(axes)]
        order = self.mesh.group_ranks(axes)
        by_rank = sorted(order)
        return pgs, order, [by_rank.index(r) for r in order]

    # ----------------------------------------------------------- transport

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The operand as the backend takes it (pinned host copy of a
        CUDA tensor under gloo), contiguous."""
        t = t.contiguous()
        if self.host_staged and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.host_staged_bytes += h.numel() * h.element_size()
            return h
        return t

    def _exchange(self, pgs, src: torch.Tensor, rows: int, kind: str
                  ) -> torch.Tensor:
        """One collective over the groups `pgs` of a (r, m) operand:
        "gather" (r = 1; each member's row, in group rank order) or
        "alltoall" (r = rows; row j to group rank j, row j of the result
        from it). Columns go out in up to `channels` pieces at once; the
        result, (rows, m), is on `src`'s device."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        m = src.shape[1]
        k = max(1, min(len(pgs), m * src.element_size() // MIN_PIECE))
        cuts = [m * i // k for i in range(k + 1)]
        out = torch.empty((rows, m), dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        works = []
        for i in range(k):
            a, b = cuts[i], cuts[i + 1]
            t1 = time.perf_counter()
            piece = self._out(src[:, a:b])
            self.seconds["stage"] += time.perf_counter() - t1
            got = torch.empty((rows, b - a), dtype=piece.dtype,
                              device=piece.device,
                              pin_memory=piece.device != out.device)
            if kind == "gather":
                w = gather(got.view(-1), piece.view(-1), group=pgs[i],
                           async_op=True)
            else:
                w = dist.all_to_all_single(got, piece, group=pgs[i],
                                           async_op=True)
            works.append((w, got, a, b))
        for w, got, a, b in works:
            t1 = time.perf_counter()
            w.wait()
            self.seconds["wait"] += time.perf_counter() - t1
            if got.device != out.device:
                self.host_staged_bytes += got.numel() * got.element_size()
            out[:, a:b].copy_(got, non_blocking=True)
        self.seconds["total"] += time.perf_counter() - t0
        return out

    # ------------------------------------------------------- collectives

    def all_gather(self, t: torch.Tensor, axes) -> List[torch.Tensor]:
        """Every member's `t` (same shape), in the order of the members'
        linear index over `axes`."""
        g = self._group(axes)
        if g is None:
            return [t]
        pgs, _, pos = g
        with self._op() as outer:
            buf = self._exchange(pgs, t.reshape(1, -1), len(pos), "gather")
            buf = buf.view((len(pos),) + tuple(t.shape))
            out = [buf[p] for p in pos]
        if outer:
            self._record("all_gather", out, len(pos))
        return out

    def all_gather_cat(self, t: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        with self._op() as outer:
            parts = self.all_gather(t, axes)
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
        if outer:
            self._record("all_gather_cat", out, len(parts))
        return out

    def all_reduce_max(self, t: torch.Tensor, axes) -> torch.Tensor:
        with self._op() as outer:
            parts = self.all_gather(t, axes)
            out = parts[0]
            for p in parts[1:]:
                out = torch.maximum(out, p)
        if outer:
            self._record("all_reduce_max", out, len(parts))
        return out

    def reduce_scatter_sum(self, t: torch.Tensor, axes, dim: int
                           ) -> torch.Tensor:
        """This member's chunk (its linear index over `axes`) of `t`
        split along `dim`, summed over the members in index order."""
        import torch.distributed as dist
        g = self._group(axes)
        if g is None:
            return t
        pgs, order, pos = g
        n = len(order)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {n} ranks")
        with self._op() as outer:
            chunks = t.movedim(dim, 0).chunk(n, dim=0)
            # group rank j (the j-th lowest global rank) gets the chunk of
            # its own linear index
            by_rank = sorted(order)
            src = torch.stack([chunks[order.index(r)] for r in by_rank])
            buf = self._exchange(pgs, src.reshape(n, -1), n, "alltoall")
            buf = buf.view(src.shape)
            out = buf[pos[0]]
            for p in pos[1:]:
                out = out + buf[p]
            out = out.movedim(0, dim).contiguous()
        if outer:
            self._record("reduce_scatter_sum", out, n)
        return out

    def all_reduce_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The members' `t` summed in index order (a reduce-scatter of
        the flattened tensor, then an all-gather): the same bits on every
        member."""
        n = self.size(axes)
        if n == 1:
            return t
        with self._op() as outer:
            flat = t.reshape(-1)
            pad = (-flat.numel()) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            mine = self.reduce_scatter_sum(flat, axes, 0)
            out = self.all_gather_cat(mine, axes, 0)
            out = out[:t.numel()].reshape(t.shape)
        if outer:
            self._record("all_reduce_sum", out, n)
        return out

    def gather_objects(self, obj, axes=None) -> List[Any]:
        """Every member's picklable `obj` (over the whole mesh by
        default), in linear index order."""
        import torch.distributed as dist
        g = self._group(self.mesh.axis_names if axes is None else axes)
        if g is None:
            return [obj]
        pgs, _, pos = g
        out = [None] * len(pos)
        dist.all_gather_object(out, obj, group=pgs[0])
        return [out[p] for p in pos]

    def _peer(self, axis: str, index: int) -> Tuple[Any, int]:
        """(the axis group's first channel, the global rank at `index` on
        `axis` with this rank's other coordinates)."""
        pgs = self._groups[self._canon((axis,))]
        return pgs[0], self.mesh.group_ranks((axis,))[index]

    def send(self, t: torch.Tensor, axis: str, to: int) -> None:
        """Send `t` to the member at index `to` on `axis` (blocking; the
        receiver posts a `recv` of the same shape and dtype)."""
        with self._op() as outer:
            self._send(t, axis, to)
        if outer:
            self._record("send", t, self.mesh.shape[axis])

    def _send(self, t, axis, to) -> None:
        import torch.distributed as dist
        t0 = time.perf_counter()
        pg, dst = self._peer(axis, to)
        dist.send(self._out(t), dst=dst, group=pg)
        self.seconds["total"] += time.perf_counter() - t0

    def recv(self, shape, dtype, device, axis: str, frm: int
             ) -> torch.Tensor:
        """The tensor the member at index `frm` on `axis` sends, on
        `device`."""
        with self._op() as outer:
            buf = self._recv(shape, dtype, device, axis, frm)
        if outer:
            self._record("recv", buf, self.mesh.shape[axis])
        return buf

    def _recv(self, shape, dtype, device, axis, frm) -> torch.Tensor:
        import torch.distributed as dist
        t0 = time.perf_counter()
        pg, src = self._peer(axis, frm)
        staged = self.host_staged and torch.device(device).type == "cuda"
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if staged else device,
                          pin_memory=staged)
        dist.recv(buf, src=src, group=pg)
        if staged:
            self.host_staged_bytes += buf.numel() * buf.element_size()
            buf = buf.to(device)
        self.seconds["total"] += time.perf_counter() - t0
        return buf

    def broadcast(self, t: Optional[torch.Tensor], axis: str, src: int, *,
                  shape=None, dtype=None, device=None) -> torch.Tensor:
        """The member at index `src` on `axis` sends `t`; every member
        returns it (the others pass None with its shape, dtype and
        device)."""
        if self.mesh.shape[axis] == 1:
            return t
        with self._op() as outer:
            out = self._broadcast(t, axis, src, shape, dtype, device)
        if outer:
            self._record("broadcast", out, self.mesh.shape[axis])
        return out

    def _broadcast(self, t, axis, src, shape, dtype, device):
        import torch.distributed as dist
        t0 = time.perf_counter()
        pg, root = self._peer(axis, src)
        if self.mesh.coords[axis] == src:
            buf = self._out(t)
            out = t
        else:
            staged = self.host_staged and torch.device(device).type == "cuda"
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device="cpu" if staged else device,
                              pin_memory=staged)
            out = None
        dist.broadcast(buf, src=root, group=pg)
        if out is None:
            if buf.device != torch.device(device):
                self.host_staged_bytes += buf.numel() * buf.element_size()
            out = buf.to(device)
        self.seconds["total"] += time.perf_counter() - t0
        return out

    def barrier(self, axes=None) -> None:
        self.gather_objects(None, axes)

    def describe(self) -> str:
        dims = "x".join(str(self.mesh.shape[a])
                        for a in self.mesh.axis_names)
        return (f"mesh {dims} {self.mesh.axis_names} over "
                f"{self.backend}: {self.why}")


class DryComm(Comm):
    """A `Comm` with no process group, for a dry run: every collective
    returns a tensor of its result's shape, on the meta device one that
    holds nothing, and counts itself as `Comm` does. Off the meta device
    (a rank's small host operands) each member is taken to hold what
    this one holds: a gather repeats it, a sum multiplies it by the
    group's size. Object gathers return this member's object for each."""

    def __init__(self, mesh: Mesh, *, why: str = (
            "dry run: no process group, each collective counted and its "
            "result's shape returned")):
        self._setup(mesh, "dry", False, why)
        self.channels = 1
        self._groups = {}
        mesh.comm = self

    def _group(self, axes):
        axes = tuple(a for a in axes if self.mesh.shape[a] > 1)
        if not axes:
            return None
        order = self.mesh.group_ranks(axes)
        by_rank = sorted(order)
        # the "channels": this member's position in the group rank order
        return [by_rank.index(self.mesh.rank)], order, [
            by_rank.index(r) for r in order]

    def _exchange(self, pgs, src, rows, kind):
        if src.device.type == "meta":
            return torch.empty((rows, src.shape[1]), dtype=src.dtype,
                               device=src.device)
        row = src[0] if kind == "gather" else src[pgs[0]]
        return row.expand(rows, -1).clone()

    def _send(self, t, axis, to) -> None:
        pass

    def _recv(self, shape, dtype, device, axis, frm):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)

    def _broadcast(self, t, axis, src, shape, dtype, device):
        if self.mesh.coords[axis] == src:
            return t
        return torch.zeros(tuple(shape), dtype=dtype, device=device)

    def gather_objects(self, obj, axes=None) -> List[Any]:
        return [obj] * self.size(self.mesh.axis_names if axes is None
                                 else axes)

    def store(self):
        raise RuntimeError("a DryComm has no process group, so no store")


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def single_node_gloo() -> None:
    """gloo between ranks of one node over the loopback device (unless
    the caller named one), not through the host's network address. Call
    before the process group is made."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")


def init_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: str = "cuda") -> Mesh:
    """This rank's `Mesh` over the world of `torch.distributed`, with its
    `Comm`. Initialises the default group by the backend rule when the
    caller has not (from the environment `torch.distributed.run` sets);
    the world size must equal the mesh size, as the JAX CLI requires
    that many devices (`repro/launch/train.py:173`)."""
    import torch.distributed as dist
    n = math.prod(int(x) for x in shape)
    kind = "cpu" if device == "cpu" else "cuda"
    initialised = dist.is_initialized()
    world = (dist.get_world_size() if initialised
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != n:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} "
                         f"processes, have {world} (run it under "
                         f"python -m torch.distributed.run "
                         f"--nproc-per-node {n})")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, staged, why = backend_rule(
        kind, local, torch.cuda.device_count() if kind == "cuda" else 0)
    if not initialised:
        if backend == "gloo" and local == world:
            single_node_gloo()
        dist.init_process_group(backend)
    elif str(dist.get_backend()) != backend:
        backend = str(dist.get_backend())
        staged = kind == "cuda" and backend == "gloo"
        why = f"{backend}, the caller's process group"
    mesh = Mesh(shape, axis_names, rank=dist.get_rank())
    Comm(mesh, host_staged=staged, backend=backend, why=why)
    return mesh


def mesh_from_arg(text: str, *, device: str) -> Optional[Mesh]:
    """`--mesh RxC`: None for one rank, else this rank's mesh."""
    shape, names = parse_mesh(text)
    return (init_mesh(shape, names, device=device) if math.prod(shape) > 1
            else None)


# ====================================================================
# Tensor parallelism inside a stage
# ====================================================================

_SCOPE = threading.local()


class _Scope:
    __slots__ = ("region", "refs", "ptrs")

    def __init__(self):
        self.region = "rep"
        self.refs: List[torch.Tensor] = []   # held: their addresses stay
        self.ptrs = set()


@contextlib.contextmanager
def save_scope():
    """Classify what a stage's forward saves (`saved_replicated`)."""
    prev = getattr(_SCOPE, "cur", None)
    _SCOPE.cur = _Scope()
    try:
        yield _SCOPE.cur
    finally:
        _SCOPE.cur = prev


def saved_replicated(t: torch.Tensor) -> bool:
    """True when the tensor a stage's forward saves is identical on every
    rank of the tensor axis: saved outside a parallel region, or the
    input of `enter`. False outside a `save_scope`."""
    sc = getattr(_SCOPE, "cur", None)
    if sc is None:
        return False
    return sc.region == "rep" or storage_ptr(t) in sc.ptrs


def _set_region(region: str, marked: Optional[torch.Tensor] = None):
    sc = getattr(_SCOPE, "cur", None)
    if sc is None:
        return
    sc.region = region
    if marked is not None:
        _mark_replicated(marked)


def _mark_replicated(t: torch.Tensor) -> None:
    sc = getattr(_SCOPE, "cur", None)
    if sc is not None:
        sc.refs.append(t)
        sc.ptrs.add(storage_ptr(t))


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.comm.all_reduce_sum(g, ctx.tp.axes), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp):
        return tp.comm.all_reduce_sum(y, tp.axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, t.shape[dim]
        return tp.comm.all_gather_cat(t, tp.axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _CopyManyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *ws):
        ctx.tp = tp
        ctx.shapes = [(w.shape, w.dtype, w.device) for w in ws]
        return tuple(w.view_as(w) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
              for g, (shape, dt, dev) in zip(gs, ctx.shapes)]
        out = [None] * len(gs)
        for dt in dict.fromkeys(g.dtype for g in gs):
            # one message a dtype
            idx = [i for i, g in enumerate(gs) if g.dtype == dt]
            flat = ctx.tp.comm.all_reduce_sum(
                torch.cat([gs[i].reshape(-1) for i in idx]), ctx.tp.axes)
            for i, piece in zip(idx, flat.split([gs[i].numel()
                                                 for i in idx])):
                out[i] = piece.view(gs[i].shape)
        return (None,) + tuple(out)


class _GatherToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.comm.all_gather_cat(t, tp.axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.comm.reduce_scatter_sum(g, ctx.tp.axes,
                                              ctx.dim), None, None


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return tp.comm.all_reduce_sum(t, tp.axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.comm.all_reduce_sum(g, ctx.tp.axes), None


class TpGroup:
    """The tensor axis as a block sees it: `size` ranks, this one at
    `rank`, collectives through `comm`."""

    def __init__(self, comm: Comm, axis: str):
        self.comm, self.axis, self.axes = comm, axis, (axis,)
        self.size = comm.mesh.shape[axis]
        self.rank = comm.mesh.coords[axis]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        _set_region("tp", x)
        return _CopyToTp.apply(x, self)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        out = _ReduceFromTp.apply(y, self)
        _set_region("rep")
        return out

    def grad_sum(self, *ws: torch.Tensor):
        """Values replicated over the axis that a parallel region reads
        (their storage is marked replicated for the pack hook): each of
        `ws`, or the one value given, its gradient summed over the axis
        (all of them in one message)."""
        for w in ws:
            _mark_replicated(w)
        out = _CopyManyToTp.apply(self, *ws)
        return out[0] if len(ws) == 1 else out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromTp.apply(t, dim, self)

    def gather_partial(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of `t` (this rank's slice along `dim`) on every rank,
        read inside a parallel region: each rank's gradient of the whole
        is partial, so backward sums them and hands each its slice. The
        whole is the same on every rank (stored as 1/tp slices)."""
        out = _GatherToTp.apply(t, dim, self)
        _mark_replicated(out)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of `t` (this rank's slice along `dim`) on every
        rank, with no backward: serving's gathers (the logits' vocab
        columns, the RG-LRU gates' input at decode)."""
        return self.comm.all_gather_cat(t, self.axes, dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the axis, where every rank's outputs read the
        sum: its gradient is summed over the axis too."""
        return _SumBothWays.apply(t, self)

    @contextlib.contextmanager
    def region(self):
        """Values computed inside differ across the axis."""
        _set_region("tp")
        try:
            yield
        finally:
            _set_region("rep")

    def local_heads(self, n_heads: int) -> Tuple[int, int]:
        """(first, count) of this rank's heads of `n_heads`."""
        n = n_heads // self.size
        return self.rank * n, n


def tp_group(settings) -> Optional[TpGroup]:
    """The tensor axis of `settings` (RunSettings with `mesh` and
    `tp_axis`), or None when the run has none (or it has one rank)."""
    return axis_group(getattr(settings, "mesh", None),
                      getattr(settings, "tp_axis", None))


def axis_group(mesh, axis: Optional[str]) -> Optional[TpGroup]:
    """`axis` of `mesh` as a block sees a tensor axis (one per mesh and
    axis), or None for no mesh, no axis or an axis of one rank."""
    if mesh is None or axis is None or mesh.shape.get(axis, 1) <= 1:
        return None
    cache = mesh.__dict__.setdefault("_tp_groups", {})
    if axis not in cache:
        cache[axis] = TpGroup(mesh.comm, axis)
    return cache[axis]


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axes):
        return comm.all_reduce_sum(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(t: torch.Tensor, comm: Comm, axes) -> torch.Tensor:
    """`t` summed over the members of `axes` in index order (the same
    bits on every member). The backward is the identity: each member's
    gradient is that of its own term, and a caller whose gradients are
    then averaged over `axes` scales its seed by their size (the
    engine's MoE aux terms, `core/engine.py`)."""
    if comm.size(axes) == 1:
        return t
    return _SumOver.apply(t, comm, tuple(axes))


# ====================================================================
# Vocab-parallel cross-entropy
# ====================================================================

def vocab_parallel_terms(z, labels, tp: TpGroup):
    """(sum of the masked NLL, token count, lse) of logits `z` (B, S, Vl),
    this rank's columns [rank*Vl, (rank+1)*Vl) of the vocab: the global
    max, the sum of exponentials and the picked logit are all-reduced
    over the tensor axis."""
    vl = z.shape[-1]
    off = tp.rank * vl
    mask = (labels >= 0).float()
    m = tp.comm.all_reduce_max(z.amax(dim=-1), tp.axes)
    s = tp.comm.all_reduce_sum(torch.exp(z - m[..., None]).sum(dim=-1),
                               tp.axes)
    lse = m + torch.log(s)
    onehot = _onehot(labels, off, vl)
    picked = tp.comm.all_reduce_sum(torch.where(onehot, z, 0.0).sum(dim=-1),
                                    tp.axes)
    return ((lse - picked) * mask).sum(), mask.sum(), lse


def _onehot(labels, off: int, vl: int):
    """(B, S, Vl) bool: each row's label column among this rank's (a
    label < 0 picks global column 0; its row is masked out)."""
    cols = torch.arange(off, off + vl, device=labels.device)
    return cols[None, None] == labels.clamp_min(0)[..., None]


def vocab_parallel_dlogits(z, labels, lse, coef, off: int):
    """d(mean CE)/d z for this rank's columns: (softmax - onehot) on the
    masked rows, times `coef` (the upstream gradient over the tokens)."""
    d = torch.exp(z - lse[..., None])
    d.sub_(_onehot(labels, off, z.shape[-1]).float())
    d.mul_((coef * (labels >= 0).float())[..., None])
    return d


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, labels, tp):
        nll, tokens, lse = vocab_parallel_terms(z, labels, tp)
        ctx.save_for_backward(z, labels, lse)
        ctx.tp = tp
        ctx.mark_non_differentiable(tokens)
        return nll / tokens.clamp_min(1.0), tokens

    @staticmethod
    def backward(ctx, g, _):
        z, labels, lse = ctx.saved_tensors
        coef = g.float() / (labels >= 0).sum().float().clamp_min(1.0)
        off = ctx.tp.rank * z.shape[-1]
        return vocab_parallel_dlogits(z, labels, lse, coef, off), None, None


def vocab_parallel_ce(z, labels, tp: TpGroup):
    """Mean next-token CE over labels >= 0 of logits split over the
    vocab across the tensor axis. Returns (loss, tokens), the same on
    every rank of the axis."""
    return _VocabParallelCE.apply(z, labels, tp)


__all__ = ["Comm", "DryComm", "TpGroup", "axis_group", "backend_rule", "init_mesh",
           "mesh_from_arg", "rank_device", "save_scope", "saved_replicated",
           "shutdown", "sum_over", "tp_group",
           "vocab_parallel_ce", "vocab_parallel_dlogits",
           "vocab_parallel_terms"]
