"""Training entry point of the port: the staged engine (SSDTrain's
saved-tensor hooks -> spool -> SSD) through `TrainSession`, after the JAX
package's `repro/launch/train.py`.

  python -m repro_torch.launch.train --arch mamba2-2.7b --steps 3 \\
      --batch 1 --seq 1024 --strategy spool --spool-backend fs --codec raw
  python -m repro_torch.launch.train --arch recurrentgemma-9b \\
      --optimizer sgd --steps 3 --batch 1 --seq 2048 --strategy spool
  python -m repro_torch.launch.train --arch small-gpt --device cpu \\
      --attn-impl torch --steps 2 --batch 2 --seq 64 --min-offload 4096
  python -m repro_torch.launch.train --arch small-bert --device cpu \\
      --steps 2 --batch 2 --seq 64 --strategy spool --min-offload 4096
  python -m repro_torch.launch.train --arch small-gpt --device cpu \\
      --steps 2 --batch 2 --seq 64 --strategy spool --min-offload 4096 \\
      --ckpt ckpt --ckpt-every 1 --trace trace.json
  python -m repro_torch.launch.train ... --ckpt ckpt --resume
  python -m repro_torch.launch.train --arch gpt-h8192-l4 --engine jit \
      --opt-overlap --clip-norm 0 --steps 3 --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch small-gpt --device cpu \
      --engine jit --host-offload activations --steps 2 --batch 2 \
      --seq 64 --min-offload 4096
  python -m repro_torch.launch.train --arch qwen2.5-3b --optimizer sgd \
      --steps 3 --batch 1 --seq 1024 --strategy spool
  python -m repro_torch.launch.train --arch llama4-scout-17b-a16e:reduced \
      --device cpu --engine jit --steps 2 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch llama-3.2-vision-90b:reduced \
      --device cpu --steps 2 --batch 2 --seq 64 --strategy spool

`--arch` takes every registry id and `<id>:reduced`, the paper's
`small-gpt`, `small-bert`, `gpt-124m` and `gpt-h<H>-l<L>`. hubert-xlarge
reads frame embeddings and llama-3.2-vision-90b image patch embeddings
beside its tokens: the CLI feeds them seeded normal ones
(`data.pipeline.embedding_batches`, `data.pipeline.vision_batches`), as
no data pipeline of either package makes them.

`--engine jit` is the JAX CLI's jit engine on the port's one engine
(layers recomputed in backward by default; `--host-offload opt_state`
stages the optimizer state through the spool between steps,
`--host-offload activations` spools the layers' residuals) and
`--opt-overlap` updates each layer as its gradients land in backward,
its moments on the spool: it needs a clip-free optimizer (`--clip-norm
0`, or none given: adamw is then built without clipping) and ends the
run with an `opt-overlap:` line. The port's default engine stays
`staged` (the JAX CLI's is `jit`).

The storage stack is the JAX CLI's: `--spool-backend` takes a kind
(fs | striped | mem | tiered | managed | aio) or a spec string of
`repro_torch.io.factory` (`striped:/a,/b`, `striped@4`,
`tiered:64mb,fs`, `managed:2gb,fs`, `aio@8`, `fault@2:striped@3`);
`--stripe-dirs`, `--host-mem-budget-mb`, `--spool-align`,
`--spool-queue-depth`, `--spool-pool-mb` (the aligned pool's idle cap),
`--retry-attempts`, `--retry-backoff-ms` and the `--cache-*` family set
the rest. The end-of-run lines give the backend's bytes and rate, host
copies per byte and the pool's hit rate, the aio mode (O_DIRECT or the
buffered fallback), the stripe write balance and, when any fired, the
retries and recompute fallbacks.

`--ckpt DIR` writes checkpoints (every `--ckpt-every` steps and at the
end) in the JAX package's layout, and `--resume` continues from the
latest one; without `--ckpt` no checkpoint is written (the JAX CLI
defaults to /tmp/repro_ckpt). SIGTERM and SIGINT stop the run at the
next step boundary with a final checkpoint. `--trace OUT.json` writes a
Chrome/Perfetto trace (`python -m repro_torch.obs.validate OUT.json`
checks it) and prints the last step's overlap analysis.

`--mesh RxC` (jit engine) trains on a data x model mesh, one process
per rank under `torch.distributed.run`; rank 0 prints, first the
collective backend and why (NCCL when each rank has a GPU of its own,
gloo when ranks share one card, CUDA tensors then staged through pinned
host memory; `parallel/comm.py::backend_rule`):

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --device cpu --engine jit --mesh 2x2 \
      --arch small-gpt --steps 2 --batch 4 --seq 64 --min-offload 4096 \
      --host-offload activations

MoE archs take a mesh too (each rank runs its experts of the "model"
axis, dropless; the aux terms over the global batch), as JAX's CLI runs
them, without an `ep_axis` flag:

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --device cpu --engine jit --mesh 1x2 \
      --arch llama4-scout-17b-a16e:reduced --steps 2 --batch 2 --seq 32

mamba2 and recurrentgemma take a mesh as well (each rank runs its SSM
heads or its share of the RG-LRU width; a "model" axis that does not
divide them is refused):

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --device cpu --engine jit --mesh 1x2 \
      --arch mamba2-2.7b:reduced --steps 2 --batch 2 --seq 32

`--spool-no-dedupe` stores one copy per rank, not one per replica group.
A mesh whose size is not the world's, or one under `--engine staged`, is
refused, as the JAX CLI refuses it.

Runs on the card unless `--device cpu` is given; without CUDA it stops
rather than fall back to the CPU. `--attn-impl cuda` (the default on the
card) runs the hand-written kernels (flash attention, SSD scan, RG-LRU
scan); `--attn-impl torch` the plain paths.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import List, Optional

import torch

from repro_torch.configs import SpoolIoConfig, resolve_config
from repro_torch.core.policies import STRATEGIES
from repro_torch.data.pipeline import embedding_batches, vision_batches
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.cacheargs import add_cache_args, cache_overrides
from repro_torch.parallel.comm import mesh_from_arg, shutdown
from repro_torch.parallel.mesh import parse_mesh
from repro_torch.resilience import unwrap_chain
from repro_torch.session import TrainSession
from repro_torch.session.session import resolve_optimizer

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="small-gpt")
    ap.add_argument("--engine", choices=["jit", "staged"], default="staged")
    ap.add_argument("--strategy", default="offload", choices=STRATEGIES,
                    help="offload policy: keep | spool (every stage) | "
                         "recompute | adaptive | offload (adaptive, the "
                         "JAX package's default)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=["adamw", "sgd"],
                    default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--min-offload", type=int, default=None,
                    help="min elements to offload through the spool "
                         "(default: the paper's 2**20)")
    ap.add_argument("--spool-backend", default="fs",
                    help="storage of the activation spool: a kind (fs | "
                         "striped | mem | tiered | managed | aio) or a "
                         "spec string such as 'striped:/a,/b', "
                         "'tiered:64mb,fs', 'managed:2gb,fs', 'aio@8' or "
                         "'fault@2:striped@3'")
    ap.add_argument("--spool-dir", default=None,
                    help="spool directory (default: a fresh temp dir, "
                         "removed on close)")
    ap.add_argument("--stripe-dirs", default=None,
                    help="comma-separated stripe directories for "
                         "--spool-backend striped / tiered / managed "
                         "(default: 2 subdirs of the spool dir)")
    ap.add_argument("--codec", default="raw",
                    choices=["raw", "zlib", "byteplane"])
    ap.add_argument("--host-mem-budget-mb", type=int, default=256,
                    help="tiered backend: host-RAM tier budget in MiB")
    ap.add_argument("--spool-align", type=int, default=4096,
                    help="buffer-pool / O_DIRECT alignment (a power of "
                         "two)")
    ap.add_argument("--spool-queue-depth", type=int, default=4,
                    help="aio backend: concurrent aligned segments per "
                         "blob")
    ap.add_argument("--spool-pool-mb", type=int, default=256,
                    help="idle cap of the shared aligned buffer pool in "
                         "MiB (on the CPU a blob larger than the cap is "
                         "freed after each use, so every load of it "
                         "misses; on the card the cap rises to the most "
                         "bytes leased at once)")
    ap.add_argument("--retry-attempts", type=int, default=3,
                    help="total tries per spool I/O op before the "
                         "failure surfaces (1 disables retry)")
    ap.add_argument("--retry-backoff-ms", type=float, default=10.0,
                    help="first retry delay in ms; doubles per attempt, "
                         "capped at 250 ms")
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="global grad-norm clip (adamw defaults to 1.0); "
                         "0 disables clipping")
    ap.add_argument("--host-offload", nargs="?", const="opt_state",
                    default="none",
                    choices=["none", "opt_state", "activations"],
                    help="jit engine: what goes through the spool — "
                         "'opt_state' stages the optimizer state between "
                         "steps (a bare --host-offload means this); "
                         "'activations' spools the layers' residuals")
    ap.add_argument("--opt-overlap", action="store_true",
                    help="jit engine: eager per-layer optimizer updates "
                         "overlapped with backward, the moments on the "
                         "spool (repro_torch.optim.overlap); bitwise "
                         "equal to the serial step; needs a clip-free "
                         "optimizer and supersedes --host-offload "
                         "opt_state")
    ap.add_argument("--on-fetch-fail", default="recompute",
                    choices=["recompute", "raise"],
                    help="when a residual fetch fails: recompute the "
                         "stage from its input, or raise")
    ap.add_argument("--metrics", default=None,
                    help="append one StepReport JSON line per step here")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: no checkpoint)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint of --ckpt")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable repro_torch.obs tracing and write a "
                         "Chrome/Perfetto trace-event JSON here on exit")
    ap.add_argument("--trace-ring", type=int, default=0,
                    help="per-thread trace ring capacity in events "
                         "(default 65536; older events are dropped and "
                         "counted when a ring fills)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain paths")
    ap.add_argument("--attn-impl", default=None, choices=("cuda", "torch"),
                    help="kernels: cuda (default on the card) or the "
                         "plain torch paths (default on the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="jit engine: mesh shape, e.g. '2x2' (data x "
                         "model) or '4' (data only); one process per "
                         "rank under python -m torch.distributed.run "
                         "--nproc-per-node N (N = the mesh's size). "
                         "--host-offload activations spools each rank's "
                         "shard into one directory all ranks share")
    ap.add_argument("--spool-no-dedupe", action="store_true",
                    help="mesh activation offload: store one copy per "
                         "rank instead of one per replica group")
    add_cache_args(ap)
    args = ap.parse_args(argv)
    if args.mesh:
        if args.engine != "jit":
            ap.error("--mesh is a jit-engine flag")
        try:
            shape, _ = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        n = math.prod(shape)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if n != world:
            ap.error(f"--mesh {args.mesh} needs {n} ranks, have {world} "
                     f"(hint: python -m torch.distributed.run "
                     f"--nproc-per-node {n} -m repro_torch.launch.train "
                     f"...)")
    if args.opt_overlap:
        if args.engine != "jit":
            ap.error("--opt-overlap is a jit-engine flag")
        if args.clip_norm:
            ap.error("--opt-overlap needs a clip-free optimizer "
                     "(global-norm clipping requires every gradient "
                     "before any update); pass --clip-norm 0 or drop "
                     "the flag")
    if args.host_offload != "none" and args.engine != "jit":
        ap.error("--host-offload is a jit-engine flag")
    if args.resume and args.ckpt is None:
        ap.error("--resume needs --ckpt")
    return args


def io_config(args: argparse.Namespace) -> SpoolIoConfig:
    """The SpoolIoConfig the storage flags describe (as the JAX CLI
    builds it)."""
    cache = cache_overrides(args)
    return SpoolIoConfig(
        backend=cache.pop("backend", args.spool_backend),
        directory=args.spool_dir,
        stripe_dirs=tuple(d for d in (args.stripe_dirs or "").split(",")
                          if d),
        codec=args.codec,
        host_mem_budget_bytes=cache.pop("host_mem_budget_bytes",
                                        args.host_mem_budget_mb << 20),
        alignment=args.spool_align, queue_depth=args.spool_queue_depth,
        pool_bytes=args.spool_pool_mb << 20,
        retry_attempts=args.retry_attempts,
        retry_backoff_s=args.retry_backoff_ms / 1e3,
        on_fetch_fail=args.on_fetch_fail, host_offload=args.host_offload,
        dedupe_replicas=not args.spool_no_dedupe, **cache).validate()


def storage_lines(spool) -> List[str]:
    """End-of-run lines of the storage stack (after `wait_io`)."""
    bk = spool.backend
    io_st, dp = bk.stats, spool.data_plane_stats()
    pool = dp["pool"]
    lines = [f"backend[{bk.kind}] wrote {io_st.bytes_written / 1e6:.1f} MB"
             + (f" @ {io_st.write_bandwidth / 1e9:.2f} GB/s"
                if io_st.write_time else "")
             + f", read {io_st.bytes_read / 1e6:.1f} MB; data plane: "
             f"{dp['backend']['copies_per_byte']:.2f} host copies/byte, "
             f"pool hits {pool['hits']} misses {pool['misses']} (hit rate "
             f"{pool['hit_rate']:.0%}), trimmed {pool['trimmed']}, "
             f"idle cap {pool['idle_cap'] / 1e6:.1f} MB (peak leased "
             f"{pool['peak_leased_bytes'] / 1e6:.1f} MB), "
             f"{pool['bytes_allocated'] / 1e6:.1f} MB ever allocated, "
             f"{pool['registrations']} CUDA registrations "
             f"({pool['register_s']:.3f} s)"]
    for b in unwrap_chain(bk):
        if hasattr(b, "direct"):
            lines.append(f"aio: {'O_DIRECT' if b.direct else 'buffered + '
                         'fdatasync (the filesystem refused O_DIRECT)'} in "
                         f"{b.directory}, queue depth {b.queue_depth}")
        if hasattr(b, "per_device_write_bytes"):
            lines.append("stripe write balance: " + str(
                [f"{n / 1e6:.1f}MB" for n in b.per_device_write_bytes()]))
    rs = spool.stats
    if rs.store_retries or rs.load_retries or rs.fetch_fallbacks:
        lines.append(f"resilience: {rs.store_retries} store retries, "
                     f"{rs.load_retries} load retries, "
                     f"{rs.fetch_fallbacks} recompute fallbacks; backend "
                     f"health={spool.health.status}")
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    io = io_config(args)
    mesh = (mesh_from_arg(args.mesh, device=args.device) if args.mesh
            else None)
    try:
        _train(args, io, mesh)
    finally:
        if mesh is not None:
            shutdown()


def _train(args, io, mesh) -> None:
    """The run `main` describes; on a mesh only rank 0 prints."""
    rank0 = mesh is None or mesh.rank == 0

    def say(*a, **k):
        if rank0:
            print(*a, **k)

    if mesh is not None:
        say(mesh.comm.describe(), flush=True)
    # the overlap builds its optimizer clip-free (parse_args refused an
    # explicit clip)
    optimizer = resolve_optimizer(args.optimizer, args.lr,
                                  0 if args.opt_overlap else args.clip_norm)
    if args.opt_overlap and args.optimizer == "adamw":
        say("opt-overlap: using clip-free adamw (global-norm clipping "
            "is incompatible with eager per-layer updates)")
    kernels = (flash_attention, ssd_scan, rglru_scan)
    launches0 = [k.launches for k in kernels]
    cfg = resolve_config(args.arch)
    loader = (embedding_batches(cfg.d_model, cfg.vocab_size,
                                batch=args.batch, seq_len=args.seq,
                                seed=args.seed)
              if cfg.input_kind == "embeddings" else
              vision_batches(cfg.vocab_size, cfg.d_model,
                             cfg.encoder_seq_len, batch=args.batch,
                             seq_len=args.seq, seed=args.seed)
              if cfg.family == "vlm" else None)
    with TrainSession(
            cfg, engine=args.engine, loader=loader,
            policy=args.strategy if args.engine == "staged" else None,
            opt_overlap=args.opt_overlap or None, io=io,
            optimizer=optimizer,
            batch_size=args.batch, seq_len=args.seq, seed=args.seed,
            microbatches=args.microbatches, device=args.device,
            attn_impl=args.attn_impl,
            metrics_path=args.metrics if rank0 else None,
            min_offload_elements=args.min_offload, ckpt_dir=args.ckpt,
            ckpt_every=args.ckpt_every, trace=args.trace,
            trace_ring=args.trace_ring, mesh=mesh,
            install_signal_handlers=True) as session:
        device = (torch.cuda.get_device_name(torch.device(args.device))
                  if args.device != "cpu" else "cpu")
        placement = (f"policy={session.policy!r}" if args.engine == "staged"
                     else f"activations={session.settings.activation_policy}"
                     f" host_offload={args.host_offload} opt_overlap="
                     f"{args.opt_overlap}")
        say(f"arch={session.cfg.name} params={session.n_params / 1e6:.1f}M"
            + (" (rank 0's shard)" if mesh is not None else "")
            + f" device={device} engine={args.engine} {placement} "
            f"spool={args.spool_backend}/{args.codec} "
            f"kernels={session.settings.attn_impl}", flush=True)

        def on_report(rep):
            st = rep.stats
            dev = rep.extra.get("device_peak_bytes")
            say(f"step {rep.step:4d} loss {rep.loss:.4f} "
                f"t {rep.step_time:.3f}s act_peak "
                f"{rep.peak_activation_bytes / 1e6:.1f} MB"
                + (f" device_peak {dev / 1e9:.2f} GB" if dev else "")
                + (f" offloaded {st.bytes_offloaded / 1e6:.1f} MB loaded "
                   f"{st.bytes_loaded / 1e6:.1f} MB forwarded "
                   f"{st.bytes_forwarded / 1e6:.1f} MB" if st else ""),
                flush=True)

        t0 = time.perf_counter()
        result = session.run(args.steps, resume=args.resume,
                             on_report=on_report)
        dt = time.perf_counter() - t0
        spool = session.engine.spool
        spool.wait_io()
        say(f"done: {args.steps} steps in {dt:.2f}s; fetch fallbacks "
            f"{spool.stats.fetch_fallbacks}", flush=True)
        if session.spool is not None:
            for line in storage_lines(session.spool):
                say(line, flush=True)
        if mesh is not None:
            say(f"mesh hooks by shard (all ranks): "
                f"{session.shard_totals()}; rank 0 staged "
                f"{mesh.comm.host_staged_bytes / 1e6:.1f} MB through host "
                f"memory for {mesh.comm.backend}", flush=True)
        bridge = session.opt_bridge
        if bridge is not None and bridge.seeded:
            st = bridge.stats()
            say(f"opt-overlap: {st['opt_updates']} per-layer updates, "
                f"fetched {st['opt_fetched_bytes'] / 1e6:.1f} MB, staged "
                f"{st['opt_staged_bytes'] / 1e6:.1f} MB, skipped "
                f"{st['opt_stage_skips']} unchanged stage-backs "
                f"({st['opt_skipped_bytes'] / 1e6:.1f} MB not "
                f"rewritten)", flush=True)
        plan = session.policy.plan if session.policy is not None else None
        if plan is not None:
            say(f"plan: offload stages 0..{plan.last_offloaded} of "
                f"{len(session.engine.stage_names)}")
        ckpt = session.ckpt
        if ckpt is not None:
            say(f"checkpoint: step {ckpt.latest_step()} in {ckpt.dir} "
                f"(last snapshot {ckpt.last_snapshot_s:.3f}s, write "
                f"{ckpt.last_write_s:.3f}s)"
                + (" after preemption" if session.preempted else ""),
                flush=True)
        last_obs = next((r.obs for r in reversed(result.reports)
                         if r.obs), None)
        if last_obs and last_obs["io_busy_s"] > 0:
            say(f"overlap (last step): {last_obs['io_hidden_frac']:.0%} "
                f"of {last_obs['io_busy_s'] * 1e3:.1f} ms I/O hidden "
                f"under compute; exposed wait "
                f"{last_obs['exposed_wait_s'] * 1e3:.1f} ms: read "
                f"{last_obs['stall_read_s'] * 1e3:.1f} ms, decode "
                f"{last_obs['stall_decode_s'] * 1e3:.1f} ms, queue "
                f"{last_obs['stall_queue_s'] * 1e3:.1f} ms; store busy "
                f"{last_obs['store_s'] * 1e3:.1f} ms, load busy "
                f"{last_obs['load_s'] * 1e3:.1f} ms; prefetch hit rate "
                f"{last_obs['prefetch_hit_rate']:.0%}", flush=True)
    say("kernels: " + ", ".join(
      f"{k.__name__} launches {k.launches - n}"
      for k, n in zip(kernels, launches0)))
    # the session just closed: the trace file exists now
    if args.trace:
        say(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
