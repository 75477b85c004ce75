"""Roofline table of the port's dry run (`repro_torch.launch.dryrun`): read
its records and print the three-term roofline per (arch x shape x mesh)
cell, the counterpart of `benchmarks/roofline.py` over the JAX records.

    compute    = op-level product FLOPs / 989 TFLOP/s (bf16, dense)
    memory     = op-level HBM bytes / 3.35 TB/s
    collective = wire bytes / the link of each group size (NVLink 4,
                 450 GB/s a direction, inside an 8-card node; the node's
                 400 Gb/s network a card when the group spans nodes)

All terms are per-device seconds of one rank's traced step on the
constants of "NVIDIA H100 80GB HBM3, 700 W" (`launch/mesh.py`),
datasheet peaks, not measurements. `useful` = MODEL_FLOPS / (counted
FLOPs x chips): how much of the counted compute is 6ND (the host tier's
recompute and attention show up here). `dev_GB` is the traced live peak
of one rank.

    python -m benchmarks.torch_roofline [--dir results/dryrun_torch]
        [--mesh single] [--markdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.mesh import HBM_BW

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                           "dryrun_torch")


def load(results_dir: str = DEFAULT_DIR, mesh: Optional[str] = None
         ) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        rows.append(rec)
    return rows


def table(rows: List[Dict], *, markdown: bool = False) -> str:
    out = []
    header = ("arch", "shape", "mesh", "status", "t_comp", "t_mem_lb",
              "t_mem_ub", "t_coll", "dominant", "useful", "dev_GB",
              "trace_s")
    if markdown:
        out.append("| " + " | ".join(header) + " |")
        out.append("|" + "---|" * len(header))
    else:
        out.append(",".join(header))
    for r in rows:
        if r.get("status") != "ok":
            vals = (r["arch"], r["shape"], r.get("mesh", ""),
                    "skip" if r.get("status") == "skip" else "ERROR",
                    *("-",) * 8)
        else:
            rl = r["roofline"]
            mem = r["memory_analysis"]
            lb = r.get("hlo", {}).get("hbm_bytes_lb")
            vals = (r["arch"], r["shape"], r["mesh"], "ok",
                    f"{rl['t_compute_s']:.3f}",
                    f"{lb / HBM_BW:.3f}" if lb is not None else "-",
                    f"{rl['t_memory_s']:.3f}",
                    f"{rl['t_collective_s']:.3f}",
                    rl["dominant"],
                    f"{rl['useful_flops_ratio']:.3f}"
                    if rl.get("useful_flops_ratio") else "-",
                    f"{mem['peak_device_bytes'] / 2**30:.1f}",
                    f"{r.get('compile_s', 0):.1f}")
        sep = " | " if markdown else ","
        line = sep.join(str(v) for v in vals)
        out.append(f"| {line} |" if markdown else line)
    return "\n".join(out)


def summarize(rows: List[Dict]) -> Dict:
    ok = [r for r in rows if r.get("status") == "ok"]
    dom: Dict[str, int] = {}
    for r in ok:
        d = r["roofline"]["dominant"]
        dom[d] = dom.get(d, 0) + 1
    worst = sorted(
        (r for r in ok if r["kind"] == "train"),
        key=lambda r: (r["roofline"]["useful_flops_ratio"] or 0))
    return {"n_ok": len(ok),
            "n_skip": sum(r.get("status") == "skip" for r in rows),
            "n_err": sum(r.get("status") not in ("ok", "skip")
                         for r in rows),
            "dominant_counts": dom,
            "worst_useful": [(r["arch"], r["shape"],
                              r["roofline"]["useful_flops_ratio"])
                             for r in worst[:3]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=os.path.normpath(DEFAULT_DIR))
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--markdown", action="store_true",
                    help="the table in markdown, not the CSV rows")
    args = ap.parse_args(argv)
    rows = load(args.dir, args.mesh)
    if args.markdown:
        print(table(rows, markdown=True))
        return rows
    print("name,us_per_call,derived")
    for r in rows:
        if r.get("status") != "ok":
            continue
        rl = r["roofline"]
        lb = r.get("hlo", {}).get("hbm_bytes_lb")
        t_mem_lb = (lb / HBM_BW) if lb is not None else rl["t_memory_s"]
        bound_ub = max(rl["t_compute_s"], rl["t_memory_s"],
                       rl["t_collective_s"])
        bound_lb = max(rl["t_compute_s"], t_mem_lb, rl["t_collective_s"])
        frac_ub = rl["t_compute_s"] / bound_ub if bound_ub else 0.0
        frac_lb = rl["t_compute_s"] / bound_lb if bound_lb else 0.0
        print(f"roofline/{r['arch']}-{r['shape']}-{r['mesh']},"
              f"{bound_ub * 1e6:.0f},"
              f"dominant={rl['dominant']}"
              f";frac_fusion_optimal={frac_lb:.3f}"
              f";frac_conservative={frac_ub:.3f}"
              f";useful={rl['useful_flops_ratio'] or 0:.3f}")
    s = summarize(rows)
    print(f"roofline/summary,0,ok={s['n_ok']};skip={s['n_skip']};"
          f"err={s['n_err']};dominant={s['dominant_counts']}")
    return rows


if __name__ == "__main__":
    main()
