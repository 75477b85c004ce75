"""Op-level analysis of one traced step, the port's counterpart of the JAX
package's `repro/launch/hlo_stats.py`. PyTorch has no HLO to parse, so
the analysis is a `TorchDispatchMode` (`OpCounter`) over the step as it
runs: on the meta device for the dry run (shapes only, no memory), or on
the CPU or the card, where the same code counts the same work.

  * FLOPs: 2 * M * N * K for each product (`mm`, `bmm`, `addmm`,
    `baddbmm`, and `mv` / `dot`; `einsum`, `matmul` and `linear` reach
    these). Elementwise work is ignored, as the JAX analysis ignores it;
  * HBM bytes: the tensor operands plus the results of each op that
    moves data. Views and metadata ops (`func.is_view`, `empty*`,
    `detach`, `set_`, `_local_scalar_dense`, ...) are free, as
    `_NO_TRAFFIC` is for HLO; an in-place write of indexed rows moves
    those rows twice and its indices, as a dynamic-update-slice does
    there; `hbm_bytes_lb` counts only the products' operands and
    results;
  * host bytes: what the host tier (`core/engine.py::_HostTier`) and the
    spool's offloads move off the device, reported by the engine
    (`count_host`). The JAX analysis counts host copies both ways; this
    counts the way off, which is also the way back;
  * the kernels: the CUDA kernels are called through ctypes, so the mode
    never sees them. Each wrapper reports its work (`report_kernel`, one
    `KernelWork` from the kernel module's `work(...)`), which joins the
    FLOPs and the bytes and is kept per kernel;
  * collectives: every `parallel/comm.py::Comm` op reports its result
    bytes and group size (`report_collective`), priced with the ring
    costs of `wire_bytes` (the JAX analysis's `_wire_bytes`);
  * the peak of the live device bytes: each result's storage is counted
    from its first appearance until it is freed (a weakref finalizer).
    Storages are told apart by the storage object, never by its pointer:
    every pointer on `meta` is 0. The step's arguments are counted from
    the start (`track`).

Work that is not the step's own (a collective's transport, the host
tier's copies) runs under `uncounted()`.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: `Comm` op -> the HLO collective it stands for (recv and the object
#: gathers carry no wire bytes of their own: a send counts the link)
HLO_COLLECTIVE = {
    "all_gather": "all-gather",
    "all_gather_cat": "all-gather",
    "reduce_scatter_sum": "reduce-scatter",
    "all_reduce_sum": "all-reduce",
    "all_reduce_max": "all-reduce",
    "send": "collective-permute",
    "broadcast": "collective-broadcast",
}

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
#: in-place writes of indexed rows: the rows written, read and written,
#: and the indices (the JAX analysis's rule for a dynamic-update-slice),
#: not the whole buffer
_ROW_WRITES = {"index_put_", "_index_put_impl_", "index_copy_"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "set_", "resize_", "_unsafe_view",
         "_local_scalar_dense", "lift_fresh", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "_reshape_alias",
         "record_stream"}


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Ring-cost wire bytes per device of an HLO collective over `n`
    ranks (the JAX analysis's `_wire_bytes`)."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return result_bytes * 2 * (n - 1) / n
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    if op == "collective-permute":
        return float(result_bytes)
    return result_bytes * (n - 1) / n


@dataclass
class KernelWork:
    """The work of one kernel call: the FLOPs its inputs need (what this
    run's data needs, masked pairs excluded), the bytes it must move
    (each input read once, each output written once) and the dtype its
    FLOPs run in."""
    name: str
    flops: float
    bytes: float
    dtype: str

    def bound_s(self, peaks: Dict[str, float]):
        """(least seconds on a card of `peaks`, "bytes" or
        "operations")."""
        t_bytes = self.bytes / peaks["bytes"]
        t_ops = self.flops / peaks[self.dtype]
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


@dataclass
class CollectiveStats:
    count: float = 0
    result_bytes: float = 0
    wire_bytes: float = 0.0


@dataclass
class OpAnalysis:
    """`hlo_stats.HloAnalysis`'s fields, plus the peak live bytes and the
    kernels' work."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_lb: float = 0.0
    host_bytes: float = 0.0
    dot_count: float = 0
    collectives: Dict[str, CollectiveStats] = field(default_factory=dict)
    wire_by_group_size: Dict[int, float] = field(default_factory=dict)
    peak_bytes: int = 0
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.collectives.values())

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_lb": self.hbm_bytes_lb,
            "host_bytes": self.host_bytes,
            "dot_count": self.dot_count,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collectives": {k: vars(v) for k, v in
                            self.collectives.items()},
            "wire_by_group_size": {str(k): v for k, v in
                                   self.wire_by_group_size.items()},
            "peak_bytes": self.peak_bytes,
            "kernels": self.kernels,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args) -> float:
    if name in ("mm", "bmm", "mv", "dot"):
        a, b = args[0], args[1]
    else:                               # addmm / baddbmm: bias first
        a, b = args[1], args[2]
    if name == "dot":
        return 2.0 * a.shape[0]
    if name == "mv":
        return 2.0 * a.shape[0] * a.shape[1]
    # (..., M, K) @ (..., K, N)
    lead = 1
    for d in a.shape[:-2]:
        lead *= d
    return 2.0 * lead * a.shape[-2] * a.shape[-1] * b.shape[-1]


_ACTIVE: List["OpCounter"] = []


class OpCounter(TorchDispatchMode):
    """Count one step's work on `device` ("meta", "cpu" or "cuda"):
    `with OpCounter("meta") as c: ...; c.analysis()`. The active
    counter (`active()`) also takes the kernels', the collectives' and
    the host tier's reports, from any thread (the autograd engine runs a
    card's backward on a thread of its own)."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.out = OpAnalysis()
        self.ops: Dict[str, int] = {}        # dispatched op -> calls
        self._quiet = 0
        self._live: Dict[int, int] = {}      # id(storage) -> bytes
        self._off: Dict[int, int] = {}       # moved off the device
        self._current = 0

    # ------------------------------------------------------------ modes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def analysis(self) -> OpAnalysis:
        return self.out

    # ------------------------------------------------------- live bytes

    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and \
            t.device.type == self.device_type

    def track(self, tree) -> None:
        """Count the storages of the tensors of `tree` as live from now
        until each is freed."""
        for t in tree_flatten(tree)[0]:
            if self._on_device(t):
                self._track_storage(t.untyped_storage())

    def _track_storage(self, st) -> None:
        key = id(st)
        if key in self._live or key in self._off:
            return
        n = st.nbytes()
        self._live[key] = n
        self._current += n
        self.out.peak_bytes = max(self.out.peak_bytes, self._current)
        weakref.finalize(st, self._died, key)

    def _died(self, key: int) -> None:
        self._current -= self._live.pop(key, 0)
        self._off.pop(key, None)

    def moved_off(self, t: torch.Tensor) -> None:
        """`t`'s storage left the device (the host tier)."""
        key = id(t.untyped_storage())
        if key in self._live:
            n = self._off[key] = self._live.pop(key)
            self._current -= n

    def moved_back(self, t: torch.Tensor) -> None:
        key = id(t.untyped_storage())
        if key in self._off:
            n = self._live[key] = self._off.pop(key)
            self._current += n
            self.out.peak_bytes = max(self.out.peak_bytes, self._current)

    # ---------------------------------------------------------- counting

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        outs = [t for t in tree_flatten(out)[0] if self._on_device(t)]
        for t in outs:
            self._track_storage(t.untyped_storage())
        if func.is_view or name in _FREE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if self._on_device(t)]
        if not ins and not outs:
            return out
        if name in _ROW_WRITES:
            # (self, indices..., values): values twice, then the indices
            rest = [t for t in tree_flatten((args[1:], kwargs))[0]
                    if self._on_device(t)]
            traffic = _nbytes(rest[-1]) + sum(_nbytes(t) for t in rest)
        else:
            traffic = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                         for t in outs)
        self.out.hbm_bytes += traffic
        if name in _PRODUCTS:
            self.out.dot_count += 1
            self.out.flops += _product_flops(name, args)
            self.out.hbm_bytes_lb += traffic
        return out

    # ---------------------------------------------------------- reports

    def add_kernel(self, work: KernelWork) -> None:
        self.out.flops += work.flops
        self.out.hbm_bytes += work.bytes
        self.out.hbm_bytes_lb += work.bytes
        k = self.out.kernels.setdefault(
            work.name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes

    def add_collective(self, op: str, result_bytes: int, n: int) -> None:
        hlo = HLO_COLLECTIVE.get(op)
        if hlo is None or n <= 1:
            return
        st = self.out.collectives.setdefault(hlo, CollectiveStats())
        wb = wire_bytes(hlo, result_bytes, n)
        st.count += 1
        st.result_bytes += result_bytes
        st.wire_bytes += wb
        self.out.wire_by_group_size[n] = \
            self.out.wire_by_group_size.get(n, 0.0) + wb


def active() -> Optional[OpCounter]:
    """The innermost counter in effect, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def report_kernel(work: KernelWork) -> None:
    c = active()
    if c is not None:
        c.add_kernel(work)


def report_collective(op: str, result, n: int) -> None:
    """A `Comm` op of group size `n` whose result is `result` (a tensor
    or a list of them): its bytes priced, its storage counted live."""
    c = active()
    if c is None:
        return
    ts = [t for t in tree_flatten(result)[0] if isinstance(t, torch.Tensor)]
    c.track(ts)
    c.add_collective(op, sum(_nbytes(t) for t in ts), n)


def count_host(nbytes: int) -> None:
    c = active()
    if c is not None:
        c.out.host_bytes += nbytes


def moved_off(t: torch.Tensor) -> None:
    c = active()
    if c is not None:
        c.moved_off(t)


def moved_back(t: torch.Tensor) -> None:
    c = active()
    if c is not None:
        c.moved_back(t)


def track(tree) -> None:
    c = active()
    if c is not None:
        c.track(tree)


@contextlib.contextmanager
def uncounted():
    """Ops inside move no bytes of the step's own and allocate nothing
    the counter tracks (a collective's transport, the host tier's
    copies)."""
    c = active()
    if c is None:
        yield
        return
    c._quiet += 1
    try:
        yield
    finally:
        c._quiet -= 1


def op_table(counter: OpCounter) -> str:
    """The dispatched ops and their calls, most called first (the dry
    run's `--dump-ops`)."""
    rows = sorted(counter.ops.items(), key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{n}\t{name}" for name, n in rows)


__all__ = ["CollectiveStats", "HLO_COLLECTIVE", "KernelWork", "OpAnalysis",
           "OpCounter", "active", "count_host", "moved_back", "moved_off",
           "op_table", "report_collective", "report_kernel", "track",
           "uncounted", "wire_bytes"]
