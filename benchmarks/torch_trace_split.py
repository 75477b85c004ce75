"""Where a traced training step's time goes: the split of each
`engine.step` of a `repro_torch.obs` trace (the `--trace` file of
`python -m repro_torch.launch.train`) into the main thread's exposed
wait and the spool workers' busy time.

    python -m repro_torch.launch.train --arch gpt-h8192-l4 --optimizer sgd \\
        --batch 16 --seq 1024 --strategy spool --steps 3 --trace t.json
    python -m benchmarks.torch_trace_split t.json [--out rows.json]

Per step, every interval clipped to the step's span:

  exposed wait     union of `spool.fetch_wait` (the main thread blocked on
                   a load), split as `overlap.analyze` splits it: the
                   same key's `io.read`, its `codec.decode`, and the rest
                   (queued behind other loads);
  store busy       union of `spool.store`: the wait for the device-to-host
                   copy, `codec.encode` (serialize + encode) and
                   `io.write`;
  load busy        union of `spool.load`: `io.read`, `codec.decode`
                   (unpack + deserialize) and the rest, which is the
                   pinned-memory copy;
  main rest        the step minus the exposed wait: forward, backward and
                   optimizer work on the main thread (launches, hooks,
                   copies back to the card, the interpreter), from the
                   `engine.fwd` / `engine.bwd` / `engine.update` spans;
  forward host     `engine.fwd` minus any wait inside it: the forward's
                   main-thread time (with the device-to-host copies'
                   set-up: pool leases, or pinned allocations before);
  pool misses      `pool.miss` instants in the step (each a fresh
                   mapping, registered with CUDA on the card);

beside `io_hidden_frac` of `overlap.analyze` over the same window. Reads
only the trace: it runs anywhere, the card's numbers come from the
card's trace.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.obs import overlap
from repro_torch.obs.overlap import _intersect, _total, _union


def load_events(path: str) -> List[tuple]:
    """The host-thread events of a Chrome trace, back as tracer tuples
    (name, cat, ts_ns, dur_ns, args); the exporter's per-shard and
    per-tier copies are left out."""
    with open(path) as f:
        doc = json.load(f)
    out = []
    for ev in doc["traceEvents"]:
        if ev.get("pid") != 0 or ev.get("ph") not in ("X", "i"):
            continue
        dur = int(round(ev["dur"] * 1e3)) if ev["ph"] == "X" else -1
        out.append((ev["name"], ev.get("cat", ""),
                    int(round(ev["ts"] * 1e3)), dur, ev.get("args", {})))
    out.sort(key=lambda e: e[2])
    return out


def _clipped(events, names, lo, hi):
    return [(max(e[2], lo), min(e[2] + e[3], hi)) for e in events
            if e[0] in names and e[3] >= 0 and e[2] < hi
            and e[2] + e[3] > lo]


def split_step(events, step_ev) -> Dict[str, float]:
    """The split of one `engine.step` event (see the module doc)."""
    lo, hi = step_ev[2], step_ev[2] + step_ev[3]
    inside = [e for e in events if e[3] >= 0 and e[2] < hi
              and e[2] + e[3] > lo]
    clip = [(n, c, max(t, lo), min(t + d, hi) - max(t, lo), a)
            for n, c, t, d, a in inside]
    an = overlap.analyze(clip)

    def iv(*names):
        return _union(_clipped(events, names, lo, hi))

    store, load = iv(overlap.STORE_SPAN), iv(overlap.LOAD_SPAN)
    read, decode = iv("io.read"), iv(overlap.DECODE_SPAN)
    write, encode = iv("io.write"), iv(overlap.ENCODE_SPAN)
    load_s = _total(load)
    load_rd = _intersect(load, _union(read + decode))
    store_s = _total(store)
    store_we = _intersect(store, _union(write + encode))
    main = {n: sum(b - a for a, b in _clipped(events, (n,), lo, hi))
            for n in ("engine.fwd", "engine.bwd", "engine.update")}
    fwd = iv("engine.fwd")
    fwd_wait = _intersect(fwd, iv(overlap.FETCH_WAIT_SPAN))
    misses = sum(1 for e in events if e[0] == "pool.miss" and e[3] < 0
                 and lo <= e[2] < hi)
    ns = 1e9
    step_s = (hi - lo) / ns
    return {
        "step": step_ev[4].get("step"),
        "step_s": step_s,
        "exposed_wait_s": an["exposed_wait_s"],
        "stall_read_s": an["stall_read_s"],
        "stall_decode_s": an["stall_decode_s"],
        "stall_queue_s": an["stall_queue_s"],
        "store_busy_s": store_s / ns,
        "store_write_s": _intersect(store, write) / ns,
        "store_encode_s": _intersect(store, encode) / ns,
        "store_d2h_wait_s": (store_s - store_we) / ns,
        "load_busy_s": load_s / ns,
        "load_read_s": _intersect(load, read) / ns,
        "load_decode_s": _intersect(load, decode) / ns,
        "load_pinned_copy_s": (load_s - load_rd) / ns,
        "main_rest_s": step_s - an["exposed_wait_s"],
        "forward_s": main["engine.fwd"] / ns,
        "forward_host_s": (_total(fwd) - fwd_wait) / ns,
        "pool_misses": misses,
        "backward_s": main["engine.bwd"] / ns,
        "update_s": main["engine.update"] / ns,
        "io_busy_s": an["io_busy_s"],
        "io_hidden_frac": an["io_hidden_frac"],
    }


def split(path: str) -> List[Dict[str, float]]:
    events = load_events(path)
    return [split_step(events, e) for e in events
            if e[0] == "engine.step" and e[3] >= 0]


def line(r: Dict[str, float]) -> str:
    return (f"engine.step {r['step']}: {r['step_s']:.3f}s; exposed wait "
            f"{r['exposed_wait_s']:.3f}s (read {r['stall_read_s']:.3f}, "
            f"decode {r['stall_decode_s']:.3f}, queue "
            f"{r['stall_queue_s']:.3f}); store busy {r['store_busy_s']:.3f}s"
            f" (d2h wait {r['store_d2h_wait_s']:.3f}, encode "
            f"{r['store_encode_s']:.3f}, write {r['store_write_s']:.3f}); "
            f"load busy {r['load_busy_s']:.3f}s (read "
            f"{r['load_read_s']:.3f}, decode {r['load_decode_s']:.3f}, "
            f"pinned copy {r['load_pinned_copy_s']:.3f}); main rest "
            f"{r['main_rest_s']:.3f}s (fwd {r['forward_s']:.3f}, bwd "
            f"{r['backward_s']:.3f}, update {r['update_s']:.3f}); forward "
            f"host {r['forward_host_s']:.3f}s; pool misses "
            f"{r['pool_misses']}; "
            f"io_hidden_frac {r['io_hidden_frac']:.3f} of "
            f"{r['io_busy_s']:.3f}s I/O")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a repro_torch.obs trace JSON")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    rows = split(args.trace)
    for r in rows:
        print(line(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
