"""Shared plumbing of the port's paper benchmarks (`torch_fig10`,
`torch_fig11`, `torch_table4`): `TrainSession` runs of the paper's model
families, after `benchmarks/common.py`, with the same result fields plus
the device's own peak. Imports neither jax nor `benchmarks.common`: the
machine with the card has no jax.

The runs go on the card unless the caller asks for the CPU, where they
use the plain attention path in float32. The small scenarios lower the
offload filter (small models keep every residual under the paper's
2^20-element filter, as in `benchmarks/common.py`); `--paper` runs keep
the paper's filter.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig, SpoolIoConfig
from repro_torch.core.rok import RokPoint, model_flops_per_step
from repro_torch.data.pipeline import encoder_decoder_batches
from repro_torch.session import TrainSession

# the small scenarios' offload filter (benchmarks/common.py::MIN_OFFLOAD)
MIN_OFFLOAD_SMALL = 2 ** 12
SGD_LR = 3e-4
# the paper's micro-batch (Table 4: batch 16), then smaller powers of two
PAPER_BATCHES = (16, 8, 4, 2, 1)


@dataclass
class RunResult:
    """The fields of `benchmarks/common.py::RunResult`, per step, plus the
    device's peak bytes (0 on the CPU) and the layer stages' saved bytes
    (what the analytic Table 4 count models)."""
    strategy: str
    batch: int
    step_time_s: float
    peak_activation_bytes: int
    backward_begin_bytes: int
    bytes_offloaded: int
    bytes_forwarded: int
    loss: float
    n_params: int
    tokens: int
    fetch_wait_s: float = 0.0
    device_peak_bytes: int = 0
    layer_saved_bytes: int = 0

    def rok_point(self) -> RokPoint:
        return RokPoint(self.strategy, self.batch,
                        self.peak_activation_bytes, self.step_time_s,
                        model_flops_per_step(self.n_params, self.tokens))


def check_device(device: str) -> None:
    """A card run needs CUDA; it never falls back to the CPU."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"device {device!r} asked for but CUDA is not "
                         "available (pass --device cpu for the CPU)")


def run_staged(cfg: ModelConfig, *, policy: str, batch: int, seq: int,
               steps: int = 3, device: str = "cuda",
               io: Optional[SpoolIoConfig] = None, seed: int = 0,
               min_offload: Optional[int] = None) -> RunResult:
    """Train `steps` sgd steps (lr 3e-4, no momentum, as the paper's
    §4.1 runs) through `TrainSession`; the median step time of the steps
    after the first, the largest peaks of those steps, and the spool's
    bytes per step (stores drained before they are read). `min_offload`
    None is the paper's filter. An encoder-decoder's encoder reads the
    decoder's tokens."""
    if device == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    loader = (encoder_decoder_batches(cfg.vocab_size, batch=batch,
                                      seq_len=seq, seed=seed)
              if cfg.family == "encdec" else None)
    with TrainSession(cfg, policy=policy, io=io or SpoolIoConfig(),
                      optimizer="sgd", lr=SGD_LR, batch_size=batch,
                      seq_len=seq, seed=seed, device=device, loader=loader,
                      min_offload_elements=min_offload) as sess:
        n_params = sess.n_params
        reports = sess.run(steps).reports
        sess.spool.wait_io()
        total = sess.spool.stats
    post = reports[1:] or reports
    med = sorted(post, key=lambda r: r.step_time)[len(post) // 2]
    n = len(reports)
    return RunResult(
        strategy=policy, batch=batch, step_time_s=med.step_time,
        peak_activation_bytes=max(r.peak_activation_bytes for r in post),
        backward_begin_bytes=max(r.backward_begin_bytes for r in post),
        bytes_offloaded=total.bytes_offloaded // n,
        bytes_forwarded=total.bytes_forwarded // n,
        loss=post[-1].loss, n_params=n_params, tokens=batch * seq,
        fetch_wait_s=total.fetch_wait_time / n,
        device_peak_bytes=max(r.extra.get("device_peak_bytes", 0)
                              for r in post),
        layer_saved_bytes=max(r.extra["layer_saved_bytes"] for r in post))


def _run_or_none(cfg: ModelConfig, kw: dict) -> Optional[RunResult]:
    try:
        return run_staged(cfg, **kw)
    except torch.cuda.OutOfMemoryError:
        return None


def run_if_it_fits(cfg: ModelConfig, **kw) -> Optional[RunResult]:
    """`run_staged`, or None when the card runs out of memory (a batch
    that does not fit is a result of the benchmark, reported as such).
    On the card each run has a process of its own, so that neither an
    attempt that ran out of memory nor the allocator's state after
    earlier runs decides whether the next one fits, and every row's peak
    is its own run's."""
    if kw.get("device", "cuda") == "cpu":
        return _run_or_none(cfg, kw)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        return pool.submit(_run_or_none, cfg, kw).result()


def first_fit(cfg: ModelConfig, policy: str, batches, **kw
              ) -> Tuple[Optional[RunResult], List[int]]:
    """The run at the first of `batches` that fits (`run_if_it_fits`),
    and the batches tried before it that did not (all of them, with
    None, where none fits)."""
    tried = []
    for b in batches:
        res = run_if_it_fits(cfg, policy=policy, batch=b, **kw)
        if res is not None:
            return res, tried
        tried.append(b)
    return None, tried


def filesystem_of(path: str) -> str:
    """The filesystem type holding `path`, from /proc/mounts ("?" where
    that file is missing)."""
    path = os.path.realpath(path)
    best, fstype = "", "?"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, mnt, kind = line.split()[:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, fstype = mnt, kind
    except OSError:
        pass
    return fstype


class SpoolDir:
    """A fresh spool directory for a benchmark's runs (removed on exit)
    and the filesystem it lies on, which every row records."""

    def __init__(self, parent: Optional[str] = None):
        self.path = tempfile.mkdtemp(prefix="torch_bench_spool_",
                                     dir=parent)
        self.fs = filesystem_of(self.path)

    def io(self) -> SpoolIoConfig:
        return SpoolIoConfig(backend="fs", directory=self.path, codec="raw")

    def __enter__(self) -> "SpoolDir":
        return self

    def __exit__(self, *exc) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


def parse_cli(doc: str, paper_help: str, argv=None) -> argparse.Namespace:
    """The scripts' shared flags: `--paper`, `--device` (the card unless
    `--device cpu`; `--paper` needs the card) and `--out`."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--paper", action="store_true", help=paper_help)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small scenarios only)")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if args.paper and args.device == "cpu":
        ap.error("--paper runs on the card; --device cpu runs the small "
                 "scenarios")
    return args


def write_rows(rows: List[dict], path: Optional[str]) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)


def device_line(device: str) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, or "cpu"."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]
