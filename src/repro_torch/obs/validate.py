"""CLI: validate a trace-event JSON file against the exporter schema.

    python -m repro_torch.obs.validate out.json \
        [--expect spool io codec engine]

Exit 0 when the trace parses, every event satisfies the trace-event
schema, and each `--expect` category has at least one event — the CI
smoke job runs this on the `--trace` artifact so a schema regression
fails the build.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import validate_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate a repro_torch.obs Chrome trace-event JSON file")
    ap.add_argument("trace", help="path to the trace JSON")
    ap.add_argument("--expect", nargs="*", default=[],
                    help="categories that must contain >=1 event")
    args = ap.parse_args(argv)

    errors = validate_trace(args.trace, expect_cats=tuple(args.expect))
    if errors:
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1

    with open(args.trace) as f:
        doc = json.load(f)
    n = len(doc.get("traceEvents", []))
    other = doc.get("otherData", {})
    print(f"OK: {args.trace}: {n} events, "
          f"dropped={other.get('dropped_events', '?')}, "
          f"open_spans={other.get('open_spans', '?')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
