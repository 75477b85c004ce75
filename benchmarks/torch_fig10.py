"""Paper Fig. 10 on the port: step time and activation memory, every
layer's residuals kept on the device vs spooled (SSDTrain's offload), on
GPT, BERT and T5 at three (hidden, layers) scenarios, after
`benchmarks/fig10_overhead.py` (whose rows' keys each row carries, plus
the batch, both runs' device peaks, the spool directory's filesystem and
the device). T5's encoder reads the decoder's tokens, as the JAX script's
does.

    PYTHONPATH=src python -m benchmarks.torch_fig10 --paper \\
        --out chiprun_out/fig10.json                          # on the card
    PYTHONPATH=src python -m benchmarks.torch_fig10 --device cpu  # small

`--paper` runs the paper's scenarios (8192x4, 12288x3, 16384x2) at
S=1024 with sgd, at the paper's micro-batch of 16 where the keep run
fits, else the largest power of two that does (a scenario where no batch
fits is a row that says so). Without it the small scenarios (hidden
256/384/512) run at B=8, S=128. The runs go on the card unless
`--device cpu`; without CUDA they stop.
"""
from __future__ import annotations

from typing import List, Optional

from benchmarks.torch_common import (MIN_OFFLOAD_SMALL, PAPER_BATCHES,
                                     SpoolDir, check_device, device_line,
                                     first_fit, parse_cli, run_if_it_fits,
                                     write_rows)
from repro_torch.configs import (PAPER_SCENARIOS, SMALL_SCENARIOS, bert,
                                 gpt, small_bert, small_gpt, small_t5, t5)

# GPT rows first, then BERT, then T5
FAMILIES = {"gpt": (small_gpt, gpt), "bert": (small_bert, bert),
            "t5": (small_t5, t5)}


def row(fam, hidden, layers, keep, off, fs, device) -> dict:
    """One Fig. 10 row: the JAX row's keys, then the port's own."""
    return {
        "family": fam, "hidden": hidden, "layers": layers,
        "keep_step_s": keep.step_time_s,
        "offload_step_s": off.step_time_s,
        "overhead_pct": 100 * (off.step_time_s / keep.step_time_s - 1),
        "keep_peak_mb": keep.peak_activation_bytes / 1e6,
        "offload_peak_mb": off.peak_activation_bytes / 1e6,
        "peak_reduction_pct": 100 * (
            1 - off.peak_activation_bytes
            / max(keep.peak_activation_bytes, 1)),
        "bwd_begin_reduction_pct": 100 * (
            1 - off.backward_begin_bytes
            / max(keep.backward_begin_bytes, 1)),
        "offloaded_mb": off.bytes_offloaded / 1e6,
        "io_wait_pct": 100 * off.fetch_wait_s / max(off.step_time_s, 1e-9),
        "batch": keep.batch,
        "keep_device_peak_gb": keep.device_peak_bytes / 1e9,
        "offload_device_peak_gb": off.device_peak_bytes / 1e9,
        "forwarded_mb": off.bytes_forwarded / 1e6,
        "spool_fs": fs,
        "device": device,
    }


def run(batch: int = 8, seq: int = 128, steps: int = 3, *,
        device: str = "cuda", paper: bool = False,
        scenarios: Optional[list] = None,
        spool_parent: Optional[str] = None) -> List[dict]:
    """Keep vs spool per family and scenario. With `paper`, the batch is
    the first of PAPER_BATCHES whose keep run fits (`batch` is then
    unused)."""
    check_device(device)
    scenarios = scenarios or (PAPER_SCENARIOS if paper else SMALL_SCENARIOS)
    smi = device_line(device)
    rows = []
    with SpoolDir(spool_parent) as spool:
        for fam, (small, full) in FAMILIES.items():
            for hidden, layers in scenarios:
                cfg = (full if paper else small)(hidden, layers)
                kw = dict(seq=seq, steps=steps, device=device,
                          min_offload=None if paper else MIN_OFFLOAD_SMALL)
                keep, tried = first_fit(
                    cfg, "keep", PAPER_BATCHES if paper else (batch,), **kw)
                if keep is None:
                    rows.append({"family": fam, "hidden": hidden,
                                 "layers": layers, "batch": None,
                                 "note": f"keep does not fit at B in "
                                         f"{tried}", "spool_fs": spool.fs,
                                 "device": smi})
                    continue
                off = run_if_it_fits(cfg, policy="spool", batch=keep.batch,
                                     io=spool.io(), **kw)
                if off is None:
                    rows.append({"family": fam, "hidden": hidden,
                                 "layers": layers, "batch": None,
                                 "note": f"spool does not fit at B="
                                         f"{keep.batch}, keep does",
                                 "spool_fs": spool.fs, "device": smi})
                    continue
                r = row(fam, hidden, layers, keep, off, spool.fs, smi)
                if tried:
                    r["note"] = f"keep does not fit at B in {tried}"
                rows.append(r)
    return rows


def main(argv=None):
    args = parse_cli(__doc__, "the paper's scenarios at S=1024", argv)
    rows = run(seq=1024 if args.paper else 128, device=args.device,
               paper=args.paper)
    print("name,us_per_call,derived")
    for r in rows:
        name = f"fig10/{r['family']}-h{r['hidden']}-l{r['layers']}"
        if r["batch"] is None:
            print(f"{name},0,{r['note']}")
            continue
        print(f"{name},{r['offload_step_s']*1e6:.0f},"
              f"batch={r['batch']};keep_step_s={r['keep_step_s']:.4f}"
              f";overhead={r['overhead_pct']:.1f}%"
              f";io_wait={r['io_wait_pct']:.1f}%"
              f";peak_reduction={r['peak_reduction_pct']:.1f}%"
              f";keep_peak_mb={r['keep_peak_mb']:.1f}"
              f";offload_peak_mb={r['offload_peak_mb']:.1f}"
              f";device_peak_gb={r['keep_device_peak_gb']:.2f}/"
              f"{r['offload_device_peak_gb']:.2f}"
              f";offloaded_mb={r['offloaded_mb']:.1f}"
              f";spool_fs={r['spool_fs']}")
    print(rows[0]["device"] if rows else args.device)
    write_rows(rows, args.out)
    return rows


if __name__ == "__main__":
    main()
