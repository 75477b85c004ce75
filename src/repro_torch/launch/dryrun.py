"""The dry run of the port, after the JAX package's `repro/launch/dryrun.py`:
for every registry arch x shape cell at the production mesh, one rank's
whole step traced on the meta device at full width, and its account
priced with the H100's constants (`launch/mesh.py`).

JAX compiles the step for 512 host-platform stand-in devices and reads
the HLO; the port runs the step itself on `meta` tensors (shapes only,
no memory) under an `OpCounter` (`launch/op_stats.py`), as one rank of
the production mesh over a `DryComm`, which counts each collective and
moves nothing. The record has the JAX record's keys: FLOPs, HBM bytes,
host-offload bytes and collective wire bytes per device, the memory
(`memory_analysis` from the trace: the arguments, the outputs, temp =
the live peak less the arguments, and `alias_bytes`, the outputs updated
in place), which of compute, memory or collectives bounds the step, and
the predicted I/O overlap and tier residency that
`obs.overlap.predicted_vs_measured` pairs with a traced run. The JAX
record's `lower_s` and `compile_s` are the step builder's and the
trace's seconds here; `xla_cost_analysis` has no XLA behind it and is
null.

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k \\
        --mesh single --out /tmp/dr --force        # one cell, ~10 s
    python -m repro_torch.launch.dryrun --all --mesh both  # the sweep

It needs no GPU. Flags are JAX's, except `--dump-ops` (the dispatched
ops and their calls, in place of `--dump-hlo`) and `--baseline`, which
maps to `ce_chunk=0` and the plain attention in one chunk of the whole
sequence (`attn_impl="torch"`, `attn_chunk=S`: every score pair
computed, no flash kernel and no blocked causal attention).

A prefill, decode or long_500k cell traces one rank's serving step
(`launch/steps.py`): weights TP-only up to `SERVE_TP_ONLY_BUDGET` a
card, fsdp above it (each layer gathered before it runs), the rank's
rows and its share of the cache. A cell `cell_skip_reason` skips
(decode of an encoder-only model, full attention at 524k) is recorded
as skipped with its reason; so is a cell whose mesh the port refuses
(`core/meshrun.py::check_mesh_config`: a tensor axis that does not
divide the query heads, the SSM heads or the RG-LRU width, which JAX
replicates).
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.cache.manager import plan_residency
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.configs.registry import cell_skip_reason
from repro_torch.core.meshrun import check_mesh_config
from repro_torch.core.tree import tree_flatten
from repro_torch.io.backend import NOMINAL_WRITE_BW
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     collective_seconds,
                                     make_production_mesh, mesh_axes)
from repro_torch.launch.op_stats import OpCounter, op_table
from repro_torch.launch.steps import (count_params, global_params,
                                      make_step)
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import adamw, sgd

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# AdamW fp32 moments for a ~1T-param model cannot fit any per-card HBM at
# this scale; the paper hit the same wall on A100-40GB and switched to SGD
# (§4.1), as the JAX dry run does for the trillion-param cell.
SGD_PARAM_THRESHOLD = 400e9

#: the card the constants are, beside every priced record
DEVICE = "NVIDIA H100 80GB HBM3, 700 W (SXM5), datasheet peaks"


def _slug(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch.replace('.', '_')}__{shape}__{mesh_name}"


def model_flops(kind: str, n_params: int, n_active: int,
                tokens: int) -> float:
    """6ND for training (fwd+bwd), 2ND for forward-only serving."""
    n = n_active
    return (6.0 if kind == "train" else 2.0) * n * tokens


def _predict_overlap(host_bytes: float, write_bw: float,
                     t_compute: float, *,
                     opt_bytes: float = 0.0,
                     opt_update_flops: float = 0.0) -> Dict[str, Any]:
    """Roofline prediction of how much activation I/O the step can hide
    (the JAX dry run's, key for key): stores ride the forward window
    (a third of the 6ND step), fetches the backward's (two thirds); what
    does not fit its window is exposed. With `opt_bytes` (per-device
    optimizer-moment bytes) the eager per-layer optimizer schedule's
    fetch and stage share the backward window's leftover."""
    t_store = host_bytes / write_bw
    t_fetch = host_bytes / write_bw
    t_io = t_store + t_fetch
    t_fwd = t_compute / 3.0
    t_bwd = t_compute * 2.0 / 3.0
    exposed = (max(0.0, t_store - t_fwd) + max(0.0, t_fetch - t_bwd))
    t_opt_fetch = opt_bytes / write_bw
    t_opt_stage = opt_bytes / write_bw
    t_opt_update = (opt_update_flops / PEAK_FLOPS_BF16
                    if opt_update_flops else 0.0)
    t_opt_io = t_opt_fetch + t_opt_stage
    opt_window = max(0.0, t_bwd - max(0.0, t_fetch))
    opt_exposed = max(0.0, t_opt_io + t_opt_update - opt_window) \
        if t_opt_io > 0 else 0.0
    return {
        "t_store_s": t_store,
        "t_fetch_s": t_fetch,
        "t_io_s": t_io,
        "t_fwd_s": t_fwd,
        "t_bwd_s": t_bwd,
        "per_stage_io_s": {"fwd_store": t_store, "bwd_fetch": t_fetch,
                           "bwd_opt_fetch": t_opt_fetch,
                           "bwd_opt_stage": t_opt_stage},
        "exposed_wait_s": exposed,
        "io_hidden_frac": (1.0 - exposed / t_io) if t_io > 0 else 1.0,
        "t_opt_io_s": t_opt_io,
        "t_opt_update_s": t_opt_update,
        "opt_exposed_wait_s": min(opt_exposed, t_opt_io),
        "opt_hidden_frac": ((1.0 - min(opt_exposed, t_opt_io) / t_opt_io)
                            if t_opt_io > 0 else 1.0),
    }


def _predict_residency(kind: str, host_bytes: float, n_params: int,
                       chips: int, optimizer: Optional[str],
                       host_bound_bytes: int) -> Dict[str, Any]:
    """Predicted per-class bytes per storage tier at this cell, from the
    cache manager's placement model (`cache/manager.py::plan_residency`),
    keyed as a managed run's `cache_residency` block (the JAX dry
    run's)."""
    opt_b = {"adamw": 8, "sgd": 0}.get(optimizer or "", 0)
    class_bytes = {
        "activation": int(host_bytes),
        "opt_state": (int(n_params / chips) * opt_b
                      if kind == "train" else 0),
        "kv_page": 0,
    }
    return {
        "host_bound_bytes": int(host_bound_bytes),
        "per_class": plan_residency(class_bytes,
                                    host_bound_bytes=host_bound_bytes),
    }


def _storages(tree) -> Dict[int, torch.Tensor]:
    return {id(t.untyped_storage()): t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)}


def memory_analysis(args, outputs, peak: int, host_bytes: float
                    ) -> Dict[str, int]:
    """The JAX record's memory block from a traced step: arguments and
    outputs by storage, `alias_bytes` the outputs that are arguments
    updated in place, temp the live peak less the arguments."""
    def nbytes(sts):
        return sum(t.untyped_storage().nbytes() for t in sts.values())

    a, o = _storages(args), _storages(outputs)
    arg_b, out_b = nbytes(a), nbytes(o)
    alias_b = nbytes({k: v for k, v in o.items() if k in a})
    temp_b = max(0, peak - arg_b)
    return {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
        "host_argument_bytes": 0,
        "host_temp_bytes": int(host_bytes),
        "peak_device_bytes": arg_b + out_b + temp_b - alias_b,
    }


def trace_step(bundle, device: str = "meta"):
    """(outputs, OpCounter, seconds) of one run of `bundle.fn`, its
    arguments counted live from the start."""
    t0 = time.time()
    with OpCounter(device) as counter:
        counter.track(bundle.args)
        out = bundle.fn(*bundle.args)
    return out, counter, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, dump_ops: bool = False,
             policy: Optional[str] = None, attn_chunk: int = 1024,
             force: bool = False, tag: str = "",
             baseline: bool = False,
             io_backend: str = "fs",
             cache_host_bound_mb: int = 256) -> Dict[str, Any]:
    if baseline:
        tag = tag or "paperbase"
    mesh_name = ("multi" if multi_pod else "single") + (f"-{tag}" if tag
                                                        else "")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _slug(arch, shape_name, mesh_name)
                        + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "multi_pod": multi_pod, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "policy": policy, "attn_chunk": attn_chunk,
    }
    skip = cell_skip_reason(cfg, shape)
    if skip is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        try:
            check_mesh_config(cfg, mesh, mesh_axes(mesh))
        except ValueError as e:
            skip = f"the port refuses this mesh: {e}"
    if skip:
        rec.update(status="skip", skip_reason=skip)
        _write(path, rec)
        return rec

    bundle = None
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        axes = mesh_axes(mesh)
        chips = mesh.size
        api = build_model(cfg)
        kw = dict(device="meta", attn_chunk=attn_chunk)
        if baseline:
            kw.update(attn_impl="torch", attn_chunk=shape.seq_len)
        t0 = time.time()
        n_total = count_params(global_params(api), exclude=())
        opt = sgd() if n_total > SGD_PARAM_THRESHOLD else adamw()
        rec["optimizer"] = opt.name
        bundle = make_step(api, mesh, axes, shape, optimizer=opt,
                           activation_policy=policy,
                           ce_chunk=0 if baseline else 512, **kw)
        t_build = time.time() - t0
        out, counter, t_trace = trace_step(bundle)
        ana = counter.analysis()
        if dump_ops:
            with open(path.replace(".json", ".ops.txt"), "w") as f:
                f.write(op_table(counter) + "\n")

        mf = model_flops(shape.kind, bundle.n_params, bundle.n_active,
                         bundle.tokens_per_step)
        flops_dev = ana.flops
        t_compute = flops_dev / PEAK_FLOPS_BF16
        t_memory = ana.hbm_bytes / HBM_BW
        t_coll = collective_seconds(ana.wire_by_group_size)
        dominant = max(("compute", t_compute), ("memory", t_memory),
                       ("collective", t_coll), key=lambda kv: kv[1])[0]
        write_bw = NOMINAL_WRITE_BW[io_backend]
        rec.update(
            status="ok",
            device=DEVICE,
            fsdp=bundle.fsdp,
            n_params=bundle.n_params, n_active=bundle.n_active,
            tokens_per_step=bundle.tokens_per_step,
            lower_s=round(t_build, 2), compile_s=round(t_trace, 2),
            memory_analysis=memory_analysis(bundle.args, out,
                                            ana.peak_bytes,
                                            ana.host_bytes),
            xla_cost_analysis={"flops": None, "bytes_accessed": None},
            hlo={**ana.as_dict()},
            roofline={
                "chips": chips,
                "flops_per_device": flops_dev,
                "hbm_bytes_per_device": ana.hbm_bytes,
                "wire_bytes_per_device": ana.collective_wire_bytes,
                "host_bytes_per_device": ana.host_bytes,
                "t_compute_s": t_compute,
                "t_memory_s": t_memory,
                "t_collective_s": t_coll,
                "dominant": dominant,
                "model_flops_global": mf,
                "useful_flops_ratio": (mf / (flops_dev * chips)
                                       if flops_dev else None),
                "io_backend": io_backend,
                "io_write_bw": write_bw,
                "t_host_io_s": ana.host_bytes / write_bw,
            },
            predicted_overlap=_predict_overlap(
                ana.host_bytes, write_bw, t_compute,
                opt_bytes=(int(bundle.n_params / chips)
                           * {"adamw": 8, "sgd": 0}.get(
                               rec.get("optimizer") or "", 0))),
            predicted_residency=_predict_residency(
                shape.kind, ana.host_bytes, bundle.n_params, chips,
                rec.get("optimizer"), cache_host_bound_mb << 20),
        )
    except Exception as e:  # record the failure, don't kill the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    finally:
        if bundle is not None:
            bundle.close()
    _write(path, rec)
    return rec


def _write(path: str, rec: Dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _cell_cmd(arch: str, shape: str, mesh: str, out_dir: str,
              extra) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--out", out_dir]
    return cmd + extra


def sweep(meshes, out_dir: str, force: bool, timeout: int,
          extra_args) -> int:
    """Every runnable cell in its own subprocess (a crash or a leak does
    not reach the sweep)."""
    failures = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            for mesh_name in meshes:
                slug = _slug(arch, shape.name, mesh_name)
                path = os.path.join(out_dir, slug + ".json")
                if os.path.exists(path) and not force:
                    continue
                if cell_skip_reason(cfg, shape) or shape.kind != "train":
                    run_cell(arch, shape.name,
                             multi_pod=(mesh_name == "multi"),
                             out_dir=out_dir, force=force)
                    continue
                print(f"[sweep] {slug}", flush=True)
                t0 = time.time()
                try:
                    r = subprocess.run(
                        _cell_cmd(arch, shape.name, mesh_name, out_dir,
                                  extra_args),
                        timeout=timeout, capture_output=True, text=True)
                    if r.returncode != 0:
                        failures += 1
                        _write(path, {
                            "arch": arch, "shape": shape.name,
                            "mesh": mesh_name, "status": "error",
                            "error": "subprocess failed",
                            "stderr": r.stderr[-4000:]})
                except subprocess.TimeoutExpired:
                    failures += 1
                    _write(path, {"arch": arch, "shape": shape.name,
                                  "mesh": mesh_name, "status": "error",
                                  "error": f"timeout after {timeout}s"})
                print(f"[sweep] {slug} done in {time.time()-t0:.0f}s",
                      flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run of the port on the "
                                 "meta device, priced for the H100")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell (subprocess per cell)")
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dump-ops", action="store_true",
                    help="write the dispatched ops and their calls beside "
                         "the record (the JAX dry run's --dump-hlo)")
    ap.add_argument("--policy", default=None,
                    choices=["keep", "remat", "offload", "save_names"])
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--tag", default="", help="suffix for variant runs")
    ap.add_argument("--baseline", action="store_true",
                    help="ce_chunk=0 and the plain attention over the "
                         "whole sequence, for before/after runs")
    ap.add_argument("--io-backend", default="fs",
                    choices=sorted(NOMINAL_WRITE_BW),
                    help="storage backend whose nominal write rate prices "
                         "the projected host-offload traffic")
    ap.add_argument("--cache-host-bound-mb", type=int, default=256,
                    help="pinned-host bound of the predicted_residency "
                         "block (pair with the measured run's)")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    extra = []
    if args.policy:
        extra += ["--policy", args.policy]
    if args.dump_ops:
        extra += ["--dump-ops"]
    if args.force:
        extra += ["--force"]
    if args.attn_chunk != 1024:
        extra += ["--attn-chunk", str(args.attn_chunk)]
    if args.tag:
        extra += ["--tag", args.tag]
    if args.baseline:
        extra += ["--baseline"]
    if args.io_backend != "fs":
        extra += ["--io-backend", args.io_backend]
    if args.cache_host_bound_mb != 256:
        extra += ["--cache-host-bound-mb", str(args.cache_host_bound_mb)]

    if args.all:
        n = sweep(meshes, args.out, args.force, args.timeout, extra)
        sys.exit(1 if n else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    for mesh_name in meshes:
        rec = run_cell(args.arch, args.shape,
                       multi_pod=(mesh_name == "multi"), out_dir=args.out,
                       dump_ops=args.dump_ops, policy=args.policy,
                       attn_chunk=args.attn_chunk, force=args.force,
                       tag=args.tag, baseline=args.baseline,
                       io_backend=args.io_backend,
                       cache_host_bound_mb=args.cache_host_bound_mb)
        status = rec.get("status")
        if status == "ok":
            rl = rec["roofline"]
            print(f"{args.arch} x {args.shape} [{mesh_name}] OK "
                  f"status: ok build={rec['lower_s']}s "
                  f"trace={rec['compile_s']}s dominant={rl['dominant']} "
                  f"t=(c {rl['t_compute_s']:.3e}, m {rl['t_memory_s']:.3e},"
                  f" coll {rl['t_collective_s']:.3e})s on {DEVICE}")
            print("memory:", rec["memory_analysis"])
            po = rec.get("predicted_overlap")
            if po:
                print(f"predicted overlap [{rl['io_backend']}]: "
                      f"{po['io_hidden_frac']:.0%} of "
                      f"{po['t_io_s']:.3e}s I/O hidden "
                      f"(store {po['t_store_s']:.3e}s in fwd "
                      f"{po['t_fwd_s']:.3e}s, fetch "
                      f"{po['t_fetch_s']:.3e}s in bwd "
                      f"{po['t_bwd_s']:.3e}s)")
            pr = rec.get("predicted_residency")
            if pr:
                per = {cls: (f"{b['host_ram_bytes'] >> 20}MiB host + "
                             f"{b['ssd_bytes'] >> 20}MiB ssd")
                       for cls, b in pr["per_class"].items()}
                print(f"predicted residency (host bound "
                      f"{pr['host_bound_bytes'] >> 20}MiB): {per}")
        elif status == "skip":
            print(f"{args.arch} x {args.shape} [{mesh_name}] SKIP: "
                  f"{rec['skip_reason']}")
        else:
            print(f"{args.arch} x {args.shape} [{mesh_name}] ERROR: "
                  f"{rec.get('error')}")
            print(rec.get("traceback", "")[-2000:])
            sys.exit(1)


if __name__ == "__main__":
    main()
