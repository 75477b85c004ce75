"""The shared ``--cache-*`` CLI family, a copy of the JAX package's
`repro/launch/cacheargs.py`: one knob surface for the
`repro_torch.cache` storage brain, used by the training CLI
(`launch.train`) and the serving CLI (`launch.serve`), so a placement
setup tuned on one carries to the other unchanged.
"""
from __future__ import annotations

import argparse
from typing import Dict


def add_cache_args(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group(
        "cache manager (repro_torch.cache storage brain)")
    g.add_argument("--cache-managed", action="store_true",
                   help="route the spool through the CacheManager "
                        "('managed' backend): class- and reuse-"
                        "distance-aware placement over bounded host "
                        "RAM + SSD, with background promotion and "
                        "failing-SSD fallback")
    g.add_argument("--cache-host-bound-mb", type=int, default=None,
                   metavar="MB",
                   help="pinned-host-RAM bound of the managed cache in "
                        "MiB (default: the tiered budget, "
                        "--host-mem-budget-mb where present, else 256)")
    g.add_argument("--cache-ssd", default=None, metavar="SPEC",
                   help="SSD tier as a backend spec string, e.g. 'fs', "
                        "'striped:/a,/b', 'aio:/nvme@8' (default: fs "
                        "under the spool dir, or the stripe dirs)")
    g.add_argument("--cache-promote-depth", type=int, default=2,
                   metavar="N",
                   help="lowered blobs promoted back to host RAM per "
                        "reuse-horizon hint (0 disables promotion)")


def cache_overrides(args: argparse.Namespace) -> Dict[str, object]:
    """`SpoolIoConfig` field overrides implied by the parsed
    ``--cache-*`` flags (empty-ish when the family is unused)."""
    out: Dict[str, object] = {
        "cache_promote_depth": args.cache_promote_depth,
    }
    if args.cache_managed:
        out["backend"] = "managed"
    if args.cache_host_bound_mb is not None:
        out["host_mem_budget_bytes"] = args.cache_host_bound_mb << 20
    if args.cache_ssd:
        out["cache_ssd"] = args.cache_ssd
    return out
