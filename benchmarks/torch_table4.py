"""Paper Table 4 on the port: the spool's measured bytes a step against
the analytic estimate (`repro_torch.core.endurance.offloaded_bytes_per_step`,
tp=1, the run's dtype), after `benchmarks/table4_offload.py`. The ratio is
recorded with no bar: the port's pack hook stores torch's saved tensors
(the layer stages' share is `layer_saved_mb`; the head's logits and the
embed stage ride the spool too), not the JAX vjp residuals the analytic
count models. `layer_ratio` is the exact counter's bytes for the layers
(`core.endurance.residual_bytes_per_layer` x layers, every saved tensor,
the run's attention path; `layer_exact_mb`) over the estimate.
`pcie_write_mb_s` is the rate that would hide the writes under half a
step, as in the JAX script.

    PYTHONPATH=src python -m benchmarks.torch_table4 --paper \\
        --out chiprun_out/table4.json                         # on the card
    PYTHONPATH=src python -m benchmarks.torch_table4 --device cpu  # small

`--paper` runs the paper's three BERT scenarios at S=1024 and B=16, or
the largest power of two below it whose spool run fits. Without it small
BERTs (hidden 256/384/512) run at B=8, S=128. The runs go on the card
unless `--device cpu`; without CUDA they stop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from benchmarks.torch_common import (MIN_OFFLOAD_SMALL, PAPER_BATCHES,
                                     SpoolDir, check_device, device_line,
                                     first_fit, parse_cli, write_rows)
from repro_torch.configs import (PAPER_SCENARIOS, SMALL_SCENARIOS, bert,
                                 small_bert)
from repro_torch.core.endurance import (offloaded_bytes_per_step,
                                        residual_bytes_per_layer)


def run(batch: int = 8, seq: int = 128, steps: int = 3, *,
        device: str = "cuda", paper: bool = False,
        scenarios: Optional[list] = None,
        spool_parent: Optional[str] = None) -> List[dict]:
    check_device(device)
    scenarios = scenarios or (PAPER_SCENARIOS if paper else SMALL_SCENARIOS)
    smi = device_line(device)
    rows = []
    with SpoolDir(spool_parent) as spool:
        for hidden, layers in scenarios:
            cfg = bert(hidden, layers) if paper else small_bert(hidden,
                                                               layers)
            res, tried = first_fit(
                cfg, "spool", PAPER_BATCHES if paper else (batch,), seq=seq,
                steps=steps, device=device, io=spool.io(),
                min_offload=None if paper else MIN_OFFLOAD_SMALL)
            row = {"hidden": hidden, "layers": layers, "spool_fs": spool.fs,
                   "device": smi}
            if res is None:
                row.update(batch=None, note=f"spool does not fit at B in "
                                            f"{tried}")
                rows.append(row)
                continue
            # the run's dtype: float32 on the CPU, the config's on the card
            run_cfg = (cfg if device != "cpu"
                       else dataclasses.replace(cfg, dtype="float32"))
            est = offloaded_bytes_per_step(run_cfg, res.batch, seq)
            exact = run_cfg.num_layers * residual_bytes_per_layer(
                run_cfg, res.batch, seq, offloadable_only=False,
                attn_impl="torch" if device == "cpu" else "cuda")
            row.update({
                "measured_mb": res.bytes_offloaded / 1e6,
                "estimate_mb": est / 1e6,
                "ratio": res.bytes_offloaded / max(est, 1),
                "pcie_write_mb_s": res.bytes_offloaded
                / max(res.step_time_s / 2, 1e-9) / 1e6,
                "batch": res.batch, "dtype": run_cfg.dtype,
                "layer_saved_mb": res.layer_saved_bytes / 1e6,
                "layer_exact_mb": exact / 1e6,
                "layer_ratio": exact / max(est, 1),
                "forwarded_mb": res.bytes_forwarded / 1e6,
                "step_time_s": res.step_time_s,
            })
            if tried:
                row["note"] = f"spool does not fit at B in {tried}"
            rows.append(row)
    return rows


def main(argv=None):
    args = parse_cli(__doc__, "the paper's BERT scenarios at S=1024", argv)
    rows = run(seq=1024 if args.paper else 128, device=args.device,
               paper=args.paper)
    print("name,us_per_call,derived")
    for r in rows:
        name = f"table4/h{r['hidden']}-l{r['layers']}"
        if r["batch"] is None:
            print(f"{name},0,{r['note']}")
            continue
        print(f"{name},0,batch={r['batch']};dtype={r['dtype']}"
              f";measured_mb={r['measured_mb']:.1f}"
              f";estimate_mb={r['estimate_mb']:.1f}"
              f";ratio={r['ratio']:.2f}"
              f";layer_saved_mb={r['layer_saved_mb']:.1f}"
              f";layer_ratio={r['layer_ratio']:.2f}"
              f";write_bw_mb_s={r['pcie_write_mb_s']:.0f}"
              f";spool_fs={r['spool_fs']}")
    print(rows[0]["device"] if rows else args.device)
    write_rows(rows, args.out)
    return rows


if __name__ == "__main__":
    main()
