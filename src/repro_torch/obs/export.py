"""Chrome/Perfetto trace-event export + schema validation (`repro_torch.obs`).

`write_chrome_trace` turns a `Tracer`'s rings into the trace-event JSON
format (the "JSON Array Format" with object envelope) that
chrome://tracing and https://ui.perfetto.dev load directly. Three track
groups (pids), so one run reads as three synchronized timelines:

  pid 0  host threads    — every event on its physical thread (spool
                           store/load workers, the engine's main
                           thread)
  pid 1  shards          — events that carry a `shard` arg, re-binned
                           per mesh shard (the mesh hooks' `hook.*`
                           events, `core/hooks.py`)
  pid 2  storage tiers   — backend I/O events re-binned per backend
                           kind (fs / striped / mem / tiered / aio /
                           fault), so a tiered store's RAM-vs-SSD split
                           is a visible lane change

`validate_trace` checks a trace object (or file) against the schema the
exporter promises — CI runs it on every `--trace` artifact so a
malformed trace fails the build, not the engineer who opens it a week
later.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

from repro_torch.obs.tracer import Tracer

PID_THREADS = 0
PID_SHARDS = 1
PID_TIERS = 2

_PROCESS_NAMES = {
    PID_THREADS: "repro host threads",
    PID_SHARDS: "mesh shards",
    PID_TIERS: "storage tiers",
}

#: phases the exporter emits / the validator accepts
VALID_PHASES = ("X", "i", "M", "C")


def _meta(pid: int, tid: int, what: str, name: str) -> Dict[str, Any]:
    return {"name": what, "ph": "M", "pid": pid, "tid": tid,
            "ts": 0, "args": {"name": name}}


def trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """Flatten the tracer's rings into trace-event dicts (ts/dur in
    microseconds relative to the tracer's epoch)."""
    t0 = tracer.t0_ns
    events: List[Dict[str, Any]] = []
    events.append(_meta(PID_THREADS, 0, "process_name",
                        _PROCESS_NAMES[PID_THREADS]))
    shard_tids: Dict[Any, int] = {}
    tier_tids: Dict[str, int] = {}

    for ring in tracer.rings():
        events.append(_meta(PID_THREADS, ring.ring_id, "thread_name",
                            ring.thread_name))
        for name, cat, ts_ns, dur_ns, args in ring.snapshot():
            base = {
                "name": name,
                "cat": cat or "default",
                "pid": PID_THREADS,
                "tid": ring.ring_id,
                "ts": (ts_ns - t0) / 1e3,
            }
            if dur_ns >= 0:
                base["ph"] = "X"
                base["dur"] = dur_ns / 1e3
            else:
                base["ph"] = "i"
                base["s"] = "t"
            if args:
                base["args"] = args
            events.append(base)

            # shard lane: any event that names its mesh shard
            shard = (args or {}).get("shard")
            if shard is not None:
                tid = shard_tids.setdefault(shard, len(shard_tids))
                events.append({**base, "pid": PID_SHARDS, "tid": tid})
            # tier lane: backend I/O events name their backend kind
            kind = (args or {}).get("kind")
            if kind is not None and name.startswith("io."):
                tid = tier_tids.setdefault(kind, len(tier_tids))
                events.append({**base, "pid": PID_TIERS, "tid": tid})

    if shard_tids:
        events.append(_meta(PID_SHARDS, 0, "process_name",
                            _PROCESS_NAMES[PID_SHARDS]))
        for shard, tid in shard_tids.items():
            events.append(_meta(PID_SHARDS, tid, "thread_name",
                                f"shard {shard}"))
    if tier_tids:
        events.append(_meta(PID_TIERS, 0, "process_name",
                            _PROCESS_NAMES[PID_TIERS]))
        for kind, tid in tier_tids.items():
            events.append(_meta(PID_TIERS, tid, "thread_name",
                                f"tier {kind}"))

    # counters become one "C" sample at export time (rates over the run;
    # the per-step series lives in the metrics JSONL, not the trace)
    counters = tracer.counters()
    if counters:
        events.append({"name": "counters", "ph": "C", "pid": PID_THREADS,
                       "tid": 0, "ts": 0,
                       "args": {k: v for k, v in sorted(counters.items())}})
    return events


def write_chrome_trace(path: str, tracer: Tracer,
                       extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the Perfetto-loadable JSON envelope; returns `path`."""
    doc = {
        "traceEvents": trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "repro_torch.obs",
            "dropped_events": tracer.dropped(),
            "total_events": tracer.total_events(),
            "open_spans": tracer.open_spans(),
            **(extra or {}),
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# ----------------------------------------------------------- validation

def validate_trace(trace: Union[str, Dict[str, Any]],
                   expect_cats: tuple = ()) -> List[str]:
    """Validate a trace document (or a path to one) against the
    trace-event schema. Returns a list of human-readable problems —
    empty means valid. `expect_cats` additionally requires at least one
    non-metadata event in each named category (CI asserts the offload
    path actually got instrumented, not just that JSON parsed)."""
    if isinstance(trace, str):
        try:
            with open(trace) as f:
                trace = json.load(f)
        except (OSError, ValueError) as e:
            return [f"unreadable trace: {e}"]
    errors: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' list"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    seen_cats: set = set()
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "pid", "tid", "ts"):
            if field not in ev:
                errors.append(f"{where}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in VALID_PHASES:
            errors.append(f"{where}: bad phase {ph!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                errors.append(f"{where}: complete event needs dur >= 0")
        if ph == "M" and "name" not in ev.get("args", {}):
            errors.append(f"{where}: metadata event needs args.name")
        if not isinstance(ev.get("ts", 0), (int, float)) \
                or ev.get("ts", 0) < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph in ("X", "i"):
            for c in str(ev.get("cat", "")).split(","):
                if c:
                    seen_cats.add(c)
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    for cat in expect_cats:
        if cat not in seen_cats:
            errors.append(f"no events in expected category {cat!r} "
                          f"(saw: {sorted(seen_cats)})")
    return errors
