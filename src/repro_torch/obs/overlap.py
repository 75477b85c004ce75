"""Overlap analyzer: turn a trace window into the paper's claim.

SSDTrain's pitch is that activation I/O is *hidden* — the SSD traffic
happens while the accelerator computes, so the training loop never
waits. `analyze()` computes that as numbers from a window of trace
events (typically one step, fed from `Tracer.snapshot_new`):

  io_busy_s        union of backend I/O span time (writes + reads)
  exposed_wait_s   union of `spool.fetch_wait` spans — the time a
                   consumer was actually blocked on the spool
  io_hidden_frac   1 - exposed/io_busy, clamped to [0, 1] — the
                   fraction of I/O that compute paid for

plus stall attribution: each exposed fetch-wait interval is intersected
with the same-key backend read and codec decode spans, splitting the
wait into "waiting for the disk", "waiting for the decoder", and the
remainder "waiting in queue" (job not yet scheduled on a load worker).

Counters (from `Tracer.counters()` deltas) contribute prefetch
hit/late/ghost rates. Everything lands in `StepReport.to_metrics()` as
`obs_*` fields, and `predicted_vs_measured` closes the loop against a
planner's prediction (the JAX package's dryrun roofline; the port has no
dryrun yet).

Optimizer-state I/O (spool keys prefixed "opt", written by the
optimizer overlap's bridge, `repro_torch.optim.overlap`, and by the
loop's between-step staging) is attributed separately: those spans are
excluded from the activation metrics above and land in `opt_io_busy_s` /
`opt_exposed_wait_s` / `opt_hidden_frac` instead, where "exposed" is
only the time the *training thread* was blocked (`engine.opt_join`
waiting on the side worker, or the serial path's `engine.opt_fetch` /
`engine.opt_stage`) — the side worker blocking on its own disk reads is
the hidden case, not a stall. `opt_hidden_frac` charges a thread block
only for its intersection with opt I/O activity (`opt_exposed_io_s`):
a join that is really riding out the worker's update kernels is compute
exposure, reported via `opt_update_s` and the join span, not I/O the
overlap failed to hide. A run without optimizer-state I/O reads zeros
and a hidden fraction of 1.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import TraceEvent

Interval = Tuple[int, int]      # (start_ns, end_ns]

#: span names produced by the instrumentation layer (single source of
#: truth so the analyzer and the call sites cannot drift apart)
IO_SPANS = ("io.write", "io.read")
DECODE_SPAN = "codec.decode"
ENCODE_SPAN = "codec.encode"
FETCH_WAIT_SPAN = "spool.fetch_wait"
STORE_SPAN = "spool.store"
LOAD_SPAN = "spool.load"
#: opt-overlap worker spans (side thread, hidden by construction) and
#: the training-thread spans that expose opt-state I/O when it is NOT
#: hidden (join = overlapped path, fetch/stage = serial path)
OPT_WORKER_SPANS = ("opt.fetch", "opt.stage")
OPT_EXPOSED_SPANS = ("engine.opt_join", "engine.opt_fetch",
                     "engine.opt_stage")
OPT_UPDATE_SPAN = "engine.opt_update"
#: spool keys carrying optimizer moments (OptBridge lease ids)
OPT_KEY_PREFIX = "opt"


def _union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge overlapping intervals; returns a sorted disjoint list."""
    ivs = sorted(i for i in intervals if i[1] > i[0])
    out: List[Interval] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _total(intervals: Iterable[Interval]) -> int:
    return sum(hi - lo for lo, hi in _union(intervals))


def _intersect(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Total overlap (ns) between two disjoint sorted interval lists."""
    total = 0
    i = j = 0
    a = _union(a)
    b = _union(b)
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans(events: Iterable[TraceEvent], names: Tuple[str, ...]
           ) -> List[TraceEvent]:
    return [ev for ev in events if ev[0] in names and ev[3] >= 0]


def _is_opt(ev: TraceEvent) -> bool:
    """True for spans keyed to an optimizer-moment spool lease."""
    key = ev[4].get("key")
    return isinstance(key, str) and key.startswith(OPT_KEY_PREFIX)


def _iv(ev: TraceEvent) -> Interval:
    return (ev[2], ev[2] + ev[3])


def analyze(events: Sequence[TraceEvent],
            counters: Optional[Dict[str, float]] = None
            ) -> Dict[str, Any]:
    """Analyze one window of trace events (see module docstring).

    `counters` is a delta of `Tracer.counters()` over the same window;
    prefetch rates are 0 when absent. All durations come back in
    seconds, fractions in [0, 1]."""
    keyed = _spans(events, IO_SPANS + (FETCH_WAIT_SPAN, STORE_SPAN,
                                       LOAD_SPAN))
    opt_keyed = [ev for ev in keyed if _is_opt(ev)]
    act = [ev for ev in keyed if not _is_opt(ev)]

    io = _spans(act, IO_SPANS)
    waits = _spans(act, (FETCH_WAIT_SPAN,))
    decodes = [ev for ev in _spans(events, (DECODE_SPAN,))
               if not _is_opt(ev)]
    encodes = [ev for ev in _spans(events, (ENCODE_SPAN,))
               if not _is_opt(ev)]
    stores = _spans(act, (STORE_SPAN,))
    loads = _spans(act, (LOAD_SPAN,))

    # opt-state I/O attribution: busy is everything the moment leases
    # kept the datapath doing (worker-side waits included — they are
    # hidden work, not stalls); exposed is training-thread time only.
    # Like the activation stall attribution below, the hidden fraction
    # charges a thread block only for the part spent over actual opt
    # I/O activity — a join riding out the side worker's jitted update
    # kernels is compute exposure (visible as engine.opt_update /
    # engine.opt_join spans), not I/O the overlap failed to hide
    opt_busy = opt_keyed + _spans(events, OPT_WORKER_SPANS)
    opt_exposed = _spans(events, OPT_EXPOSED_SPANS)
    opt_updates = _spans(events, (OPT_UPDATE_SPAN,))
    opt_busy_iv = _union(map(_iv, opt_busy))
    opt_exposed_iv = _union(map(_iv, opt_exposed))
    opt_busy_ns = _total(opt_busy_iv)
    opt_exposed_ns = _total(opt_exposed_iv)
    opt_exposed_io_ns = _intersect(opt_exposed_iv, opt_busy_iv)
    if opt_busy_ns > 0:
        opt_hidden = 1.0 - opt_exposed_io_ns / opt_busy_ns
    else:
        opt_hidden = 1.0 if opt_exposed_ns == 0 else 0.0

    io_busy_ns = _total(map(_iv, io))
    exposed_ns = _total(map(_iv, waits))

    # stall attribution: for each exposed wait, how much of it was the
    # same key's disk read vs. decode; the rest was queueing
    reads_by_key: Dict[Any, List[Interval]] = {}
    for ev in io:
        if ev[0] == "io.read":
            reads_by_key.setdefault(ev[4].get("key"), []).append(_iv(ev))
    dec_by_key: Dict[Any, List[Interval]] = {}
    for ev in decodes:
        dec_by_key.setdefault(ev[4].get("key"), []).append(_iv(ev))

    stall_read_ns = 0
    stall_decode_ns = 0
    for ev in waits:
        key = ev[4].get("key")
        w = [_iv(ev)]
        stall_read_ns += _intersect(w, reads_by_key.get(key, []))
        stall_decode_ns += _intersect(w, dec_by_key.get(key, []))
    stall_queue_ns = max(0, exposed_ns - stall_read_ns - stall_decode_ns)

    if io_busy_ns > 0:
        hidden = 1.0 - min(exposed_ns, io_busy_ns) / io_busy_ns
    else:
        hidden = 1.0 if exposed_ns == 0 else 0.0

    c = counters or {}
    issued = c.get("prefetch.issued", 0)
    res = {
        "io_busy_s": io_busy_ns / 1e9,
        "exposed_wait_s": exposed_ns / 1e9,
        "io_hidden_frac": hidden,
        "stall_read_s": stall_read_ns / 1e9,
        "stall_decode_s": stall_decode_ns / 1e9,
        "stall_queue_s": stall_queue_ns / 1e9,
        "encode_s": _total(map(_iv, encodes)) / 1e9,
        "decode_s": _total(map(_iv, decodes)) / 1e9,
        "store_s": _total(map(_iv, stores)) / 1e9,
        "load_s": _total(map(_iv, loads)) / 1e9,
        "opt_io_busy_s": opt_busy_ns / 1e9,
        "opt_exposed_wait_s": opt_exposed_ns / 1e9,
        "opt_exposed_io_s": opt_exposed_io_ns / 1e9,
        "opt_hidden_frac": opt_hidden,
        "opt_update_s": _total(map(_iv, opt_updates)) / 1e9,
        "prefetch_issued": int(issued),
        "prefetch_hit": int(c.get("prefetch.hit", 0)),
        "prefetch_late": int(c.get("prefetch.late", 0)),
        "prefetch_ghost": int(c.get("prefetch.ghost", 0)),
    }
    res["prefetch_hit_rate"] = (
        res["prefetch_hit"] / issued if issued else 0.0)
    return res


def predicted_vs_measured(predicted: Dict[str, Any],
                          measured: Dict[str, Any]) -> Dict[str, Any]:
    """Compare a dryrun `predicted_overlap` block against a measured
    `analyze()` result — the TierBandwidth calibration check. Returns
    the paired numbers plus the hidden-fraction error."""
    p_hidden = float(predicted.get("io_hidden_frac", 0.0))
    m_hidden = float(measured.get("io_hidden_frac", 0.0))
    out = {
        "predicted_io_s": float(predicted.get("t_io_s", 0.0)),
        "measured_io_s": float(measured.get("io_busy_s", 0.0)),
        "predicted_hidden_frac": p_hidden,
        "measured_hidden_frac": m_hidden,
        "hidden_frac_error": m_hidden - p_hidden,
    }
    # opt-state lane: present only when the prediction priced it (the
    # dryrun's eager-update timeline) so legacy pairings stay unchanged
    if "t_opt_io_s" in predicted:
        po = float(predicted.get("opt_hidden_frac", 0.0))
        mo = float(measured.get("opt_hidden_frac", 0.0))
        out.update({
            "predicted_opt_io_s": float(predicted["t_opt_io_s"]),
            "measured_opt_io_s": float(
                measured.get("opt_io_busy_s", 0.0)),
            "predicted_opt_hidden_frac": po,
            "measured_opt_hidden_frac": mo,
            "opt_hidden_frac_error": mo - po,
        })
    return out
