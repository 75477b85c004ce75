"""A mesh of the port trained end to end: one module-scoped spawn of 4
gloo ranks on the CPU, a (2, 2) ("data", "model") mesh, the paper's
small GPT (`small_gpt(128, 2)`, f32, adamw lr 1e-3, batch 4, seq 32,
seed 3, `min_offload_elements=256`: the JAX package's
`tests/test_multidevice.py:186-255` settings), on the JAX init's weights
(`TrainSession.set_params`). Each rank runs, in order:

  keep      the mesh, every layer kept;
  off, off2 `host_offload="activations"` on fs, twice;
  dp_keep, dp_off
            hooks (and model) over dp only (`MeshAxes(dp=("data",),
            tp=None)`): the "model" axis is one replica group;
  dp_nodup  the same without replica dedup;
  mem       dp-only dedup on the `mem` backend (refused);
  chunk     keep with `ce_chunk=16` (the vocab-parallel chunked CE);
  remat     every layer recomputed in backward (the jit default);
  archs     qwen2.5-3b:reduced on a (1, 4) mesh (its 2 kv heads whole on
            every rank), gemma2-27b:reduced and small-bert on (2, 2),
            each against a one-device session of the port.

Separate tests read the results: losses within rtol 1e-4 of the JAX
single-device jit session, offload bitwise equal to same-mesh keep, two
runs bitwise, the per-shard counts, replica dedup, an empty spool dir
after close, the `shards` block of the metrics rows; the CLI's mesh
flags are parsed here without ranks.
"""
import dataclasses
import json
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_one_thread import one_torch_thread  # noqa: E402,F401

STEPS, B, S, SEED, LR, MIN_OFF = 3, 4, 32, 3, 1e-3, 256
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_runs(rank: int, d: str, params) -> dict:
    """Every run of the module docstring, on this rank."""
    from repro_torch.configs import SpoolIoConfig, resolve_config
    from repro_torch.configs.paper_models import small_gpt
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.comm import init_mesh
    from repro_torch.parallel.sharding import MeshAxes
    from repro_torch.session import TrainSession

    cfg = dataclasses.replace(small_gpt(128, 2), dtype="float32")
    mesh = init_mesh((2, 2), ("data", "model"), device="cpu")
    dp_only = MeshAxes(dp=("data",), tp=None)
    # messages large enough to go out in pieces over the channels
    comm, axes = mesh.comm, ("data", "model")
    mine = torch.arange(3 << 18, dtype=torch.float32) * (rank + 1)
    out = {"collectives": {
        "gather": comm.all_gather_cat(mine, axes, 0),
        "sum": comm.all_reduce_sum(mine, axes),
        "scatter": comm.reduce_scatter_sum(mine.view(4, -1), axes, 0),
        "max": comm.all_reduce_max(mine, axes)}}

    def run(name, *, io=None, axes=None, ce_chunk=0, metrics=None,
            policy="keep"):
        settings = None if io is not None else RunSettings(
            attn_impl="torch", attn_chunk=32, activation_policy=policy,
            param_dtype="float32", device="cpu", ce_chunk=ce_chunk)
        with TrainSession(cfg, engine="jit", device="cpu", io=io,
                          settings=settings, optimizer=adamw(LR),
                          batch_size=B, seq_len=S, seed=SEED,
                          min_offload_elements=MIN_OFF, mesh=mesh,
                          mesh_axes=axes, metrics_path=metrics) as s:
            s.set_params(params)
            res = s.run(STEPS)
            stats = s.engine.spool.stats
            rec = {"losses": res.losses, "shards": s.shard_totals(),
                   "stored": stats.bytes_offloaded}
        if io is not None:
            rec["left"] = sorted(os.listdir(io.directory))
        out[name] = rec

    def fs(sub):
        return SpoolIoConfig(backend="fs", directory=os.path.join(d, sub),
                             host_offload="activations")

    run("keep")
    run("off", io=fs("a"), metrics=os.path.join(d, f"m{rank}.jsonl"))
    run("off2", io=fs("a"))
    run("dp_keep", axes=dp_only)
    run("dp_off", io=fs("b"), axes=dp_only)
    run("dp_nodup", io=dataclasses.replace(fs("c"), dedupe_replicas=False),
        axes=dp_only)
    try:
        run("mem", io=SpoolIoConfig(backend="mem",
                                    host_offload="activations"),
            axes=dp_only)
    except ValueError as e:
        out["mem"] = {"error": str(e)}
    # nothing stored (the layers recomputed): no replica reads a blob
    run("mem_remat", io=SpoolIoConfig(backend="mem"), axes=dp_only)
    run("chunk", ce_chunk=16)
    run("remat", policy="remat")
    # the registry's dense archs against one device: qwen2.5's 2 kv heads
    # on a 4-way model axis stay whole on every rank; gemma2's windows,
    # softcaps and post-block norms; BERT's learned positions
    quad = init_mesh((1, 4), ("data", "model"), device="cpu")
    for arch, m in (("qwen2.5-3b:reduced", quad), ("gemma2-27b:reduced", mesh),
                    ("small-bert", mesh)):
        acfg = dataclasses.replace(resolve_config(arch), dtype="float32")
        got = []
        for on in (None, m):
            with TrainSession(acfg, engine="jit", device="cpu",
                              settings=RunSettings(
                                  attn_impl="torch", attn_chunk=32,
                                  activation_policy="keep",
                                  param_dtype="float32", device="cpu"),
                              optimizer=adamw(LR), batch_size=B,
                              seq_len=S, seed=SEED, mesh=on) as s:
                got.append(s.run(2).losses)
        out[arch] = {"one": got[0], "mesh": got[1]}
    return out


def _worker(rank, port, d, params_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        with open(params_path, "rb") as f:
            params = pickle.load(f)
        out = _rank_runs(rank, d, params)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_losses(params_np_out, ce_chunk=0):
    import jax
    from repro.configs.paper_models import small_gpt as jsmall
    from repro.models.api import build_model
    from repro.models.transformer import RunSettings as JSettings
    from repro.session import TrainSession as JSession

    cfg = dataclasses.replace(jsmall(128, 2), dtype="float32")
    settings = JSettings(attn_impl="xla", attn_chunk=32,
                         activation_policy="keep", param_dtype="float32",
                         ce_chunk=ce_chunk)
    with JSession(cfg, engine="jit", settings=settings, optimizer="adamw",
                  lr=LR, batch_size=B, seq_len=S, seed=SEED,
                  ckpt_every=0, min_offload_elements=MIN_OFF) as s:
        params_np_out.append(jax.tree.map(
            np.asarray, build_model(cfg).init(jax.random.key(SEED))))
        return s.run(STEPS).losses


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    pytest.importorskip("jax")
    d = str(tmp_path_factory.mktemp("mesh_run"))
    for sub in ("a", "b", "c"):
        os.makedirs(os.path.join(d, sub))
    got = []
    ref = {"keep": _jax_losses(got), "chunk": _jax_losses([], ce_chunk=16)}
    params_path = os.path.join(d, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(got[0], f)
    mp.start_processes(_worker, args=(_free_port(), d, params_path),
                       nprocs=WORLD, start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    rows = [[json.loads(line) for line in open(os.path.join(d,
                                                            f"m{r}.jsonl"))]
            if os.path.exists(os.path.join(d, f"m{r}.jsonl")) else []
            for r in range(WORLD)]
    return {"ranks": ranks, "jax": ref, "rows": rows}


@pytest.mark.parametrize("run", ["keep", "off", "dp_off", "chunk"])
def test_losses_match_the_jax_single_device_session(mesh_runs, run):
    want = mesh_runs["jax"]["chunk" if run == "chunk" else "keep"]
    for res in mesh_runs["ranks"]:
        np.testing.assert_allclose(res[run]["losses"], want, rtol=1e-4)


@pytest.mark.parametrize("off,keep", [("off", "keep"), ("off2", "keep"),
                                      ("dp_off", "dp_keep"),
                                      ("dp_nodup", "dp_keep"),
                                      ("remat", "keep")])
def test_offload_is_bitwise_equal_to_same_mesh_keep(mesh_runs, off, keep):
    for res in mesh_runs["ranks"]:
        assert res[off]["losses"] == res[keep]["losses"]


def test_collectives_in_pieces_sum_in_rank_order(mesh_runs):
    base = torch.arange(3 << 18, dtype=torch.float32)
    for rank, res in enumerate(mesh_runs["ranks"]):
        got = res["collectives"]
        parts = [base * (r + 1) for r in range(WORLD)]
        total = parts[0] + parts[1] + parts[2] + parts[3]
        assert torch.equal(got["gather"], torch.cat(parts))
        assert torch.equal(got["sum"], total)
        assert torch.equal(got["scatter"], total.view(4, -1)[rank:rank + 1])
        assert torch.equal(got["max"], parts[3])


@pytest.mark.parametrize("arch", ["qwen2.5-3b:reduced",
                                  "gemma2-27b:reduced", "small-bert"])
def test_registry_archs_on_a_mesh_match_one_device(mesh_runs, arch):
    for res in mesh_runs["ranks"]:
        np.testing.assert_allclose(res[arch]["mesh"], res[arch]["one"],
                                   rtol=1e-4)


def test_every_rank_reports_the_same_losses(mesh_runs):
    first = mesh_runs["ranks"][0]
    for res in mesh_runs["ranks"][1:]:
        for run in ("keep", "off", "dp_off", "chunk"):
            assert res[run]["losses"] == first[run]["losses"]


def test_each_shard_offloads_and_fetches_every_layer(mesh_runs):
    shards = mesh_runs["ranks"][0]["off"]["shards"]
    assert sorted(shards) == ["0", "1", "2", "3"]
    for v in shards.values():
        assert v["offloads"] == v["fetches"] == 2 * STEPS
        assert v["replica_skips"] == 0
        assert v["bytes_in"] == v["bytes_out"] > 0


def test_hooks_over_dp_dedupe_the_model_axis(mesh_runs):
    shards = mesh_runs["ranks"][0]["dp_off"]["shards"]
    assert sorted(shards) == ["0", "1"]
    for v in shards.values():
        assert v["offloads"] == 2 * STEPS
        assert v["fetches"] == 2 * 2 * STEPS       # both replicas read
        assert v["replica_skips"] == 2 * STEPS
        assert v["bytes_out"] == 2 * v["bytes_in"] > 0
    # only the primary replicas wrote
    wrote = [r["dp_off"]["stored"] for r in mesh_runs["ranks"]]
    assert wrote[0] > 0 and wrote[2] > 0 and wrote[1] == wrote[3] == 0


def test_no_dedupe_stores_per_replica(mesh_runs):
    ranks = mesh_runs["ranks"]
    nodup, dedup = ranks[0]["dp_nodup"]["shards"], ranks[0]["dp_off"][
        "shards"]
    assert sorted(nodup) == ["0", "1", "2", "3"]
    for v in nodup.values():
        assert v["offloads"] == v["fetches"] == 2 * STEPS
        assert v["replica_skips"] == 0
    total = sum(v["bytes_in"] for v in nodup.values())
    assert total == 2 * sum(v["bytes_in"] for v in dedup.values())
    assert all(r["dp_nodup"]["stored"] > 0 for r in ranks)


def test_mem_is_refused_for_dedupe_across_ranks(mesh_runs):
    for res in mesh_runs["ranks"]:
        assert "mem" in res["mem"]["error"]
        assert "dedupe_replicas=False" in res["mem"]["error"]
        # a run that stores nothing takes it
        assert res["mem_remat"]["losses"] == res["dp_keep"]["losses"]


def test_spool_dirs_are_empty_after_close(mesh_runs):
    for res in mesh_runs["ranks"]:
        for run in ("off", "off2", "dp_off", "dp_nodup"):
            assert res[run]["left"] == [], (run, res[run]["left"])


def test_metric_rows_carry_the_shards_block(mesh_runs):
    rows = mesh_runs["rows"][0]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert sorted(r["shards"]) == ["0", "1", "2", "3"]
        assert all(v["offloads"] == v["fetches"] == 2
                   for v in r["shards"].values())
        assert r["comm_backend"] == "gloo"
        assert r["comm_host_staged_bytes"] == 0       # CPU tensors
    # the block sums the ranks' calls: every rank's row has the same one
    for other in mesh_runs["rows"][1:]:
        assert [r["shards"] for r in other] == [r["shards"] for r in rows]


def test_cli_parses_the_mesh_flags(monkeypatch):
    from repro_torch.launch import train
    base = ["--device", "cpu", "--engine", "jit"]
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = train.parse_args(base + ["--mesh", "2x2", "--spool-no-dedupe"])
    assert args.mesh == "2x2"
    assert train.io_config(args).dedupe_replicas is False
    assert train.io_config(train.parse_args(base)).dedupe_replicas is True
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = train.parse_args(base + ["--mesh", "1x2", "--opt-overlap",
                                    "--ckpt", "D", "--resume"])
    assert (args.mesh, args.opt_overlap, args.ckpt, args.resume) == (
        "1x2", True, "D", True)
    monkeypatch.setenv("WORLD_SIZE", "4")
    for bad in (["--mesh", "2x2", "--engine", "staged"],
                ["--mesh", "2x4"], ["--mesh", "2y2"]):
        with pytest.raises(SystemExit):
            train.parse_args(["--device", "cpu"] + (
                bad if "staged" in bad else ["--engine", "jit"] + bad))
