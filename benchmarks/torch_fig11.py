"""Paper Fig. 11 on the port: the recompute-offload-keep (ROK) curve on
BERT, after `benchmarks/fig11_rok.py`. Each batch runs keep, spool (every
layer's residuals through the spool) and recompute; each fitting run is
a point (activation peak, model throughput, `repro_torch.core.rok`) with
its Pareto flag. A run that does not fit on the card is a row that says
so, not a dropped point.

    PYTHONPATH=src python -m benchmarks.torch_fig11 --paper \\
        --out chiprun_out/fig11.json                          # on the card
    PYTHONPATH=src python -m benchmarks.torch_fig11 --device cpu  # small

`--paper` is bert(8192, 4) at S=1024, batches 4, 8 and 16; without it,
small_bert(384, 3) at S=128. The runs go on the card unless `--device
cpu`; without CUDA they stop.
"""
from __future__ import annotations

from typing import List, Optional

from benchmarks.torch_common import (MIN_OFFLOAD_SMALL, SpoolDir,
                                     check_device, device_line, parse_cli,
                                     run_if_it_fits, write_rows)
from repro_torch.configs import bert, small_bert
from repro_torch.core.rok import pareto_front

STRATEGIES = ("keep", "spool", "recompute")


def run(batches=(4, 8, 16), seq: int = 128, hidden: int = 384,
        layers: int = 3, steps: int = 3, *, device: str = "cuda",
        paper: bool = False, spool_parent: Optional[str] = None
        ) -> List[dict]:
    """One row per (batch, strategy): the JAX point's keys
    (`RokPoint.as_dict`), whether it is on the Pareto front, the device
    peak, the spool directory's filesystem and the device; or, for a run
    that does not fit, `fits` False."""
    check_device(device)
    cfg = bert(hidden, layers) if paper else small_bert(hidden, layers)
    smi = device_line(device)
    rows, points = [], []
    with SpoolDir(spool_parent) as spool:
        for b in batches:
            for strategy in STRATEGIES:
                res = run_if_it_fits(
                    cfg, policy=strategy, batch=b, seq=seq, steps=steps,
                    device=device,
                    io=spool.io() if strategy == "spool" else None,
                    min_offload=None if paper else MIN_OFFLOAD_SMALL)
                row = {"strategy": strategy, "batch_size": b,
                       "fits": res is not None, "model": cfg.name,
                       "spool_fs": spool.fs, "device": smi}
                if res is not None:
                    point = res.rok_point()
                    points.append(point)
                    row.update(point.as_dict(),
                               device_peak_gb=res.device_peak_bytes / 1e9,
                               offloaded_mb=res.bytes_offloaded / 1e6)
                rows.append(row)
    front = {(p.strategy, p.batch_size) for p in pareto_front(points)}
    for row in rows:
        row["pareto"] = (row["strategy"], row["batch_size"]) in front
    return rows


def main(argv=None):
    args = parse_cli(__doc__, "bert(8192, 4) at S=1024", argv)
    kw = dict(seq=1024, hidden=8192, layers=4) if args.paper else {}
    rows = run(device=args.device, paper=args.paper, **kw)
    print("name,us_per_call,derived")
    for r in rows:
        name = f"fig11/{r['strategy']}-b{r['batch_size']}"
        if not r["fits"]:
            print(f"{name},0,does not fit on {r['device']}")
            continue
        print(f"{name},{r['step_time_s']*1e6:.0f},"
              f"peak_mb={r['peak_activation_bytes']/1e6:.1f}"
              f";tput_gflops={r['throughput_flops_per_s']/1e9:.2f}"
              f";device_peak_gb={r['device_peak_gb']:.2f}"
              f";pareto={'y' if r['pareto'] else 'n'}"
              f";spool_fs={r['spool_fs']}")
    print(rows[0]["device"] if rows else args.device)
    write_rows(rows, args.out)
    return rows


if __name__ == "__main__":
    main()
