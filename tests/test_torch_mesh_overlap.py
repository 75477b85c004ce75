"""The optimizer overlap and the staged optimizer state on a mesh: one
module-scoped spawn of 4 gloo ranks on the CPU, a (2, 2) ("data",
"model") mesh, the paper's small GPT (`small_gpt(128, 2)`, f32, adamw lr
1e-3 without clipping, batch 4, seq 32, seed 3) on the JAX init's weights
(`TrainSession.set_params`), every layer kept. Each rank runs 3 steps:

  fused   the optimizer's fused update on each rank's ZeRO-1 shards;
  eager   `opt_overlap=True`: each layer updated as its reduced gradient
          shards land in backward, its moments on this rank's spool;
  sync    `opt_overlap="sync"`: the same updates drained at the step's
          end;
  serial  `io.host_offload="opt_state"`: the whole state staged through
          the spool between steps;
  resumed the eager overlap for 2 steps with a checkpoint at step 2 (its
          moments materialized first), then a fresh overlap session
          resumes it and runs step 3.

Every spool lives in one directory per run that the ranks share. The
tests: the four arms bitwise equal in losses, parameters and moments
(`materialize()` for the overlap; JAX's
`tests/test_opt_overlap.py::test_mesh_parity_subprocess` comparison),
their losses within 1e-4 of the JAX single-device session, the resumed
run bitwise equal to the eager one, the ranks' opt leases named apart
(`opt{step}L{stage}/s{rank}`, `opt{step}/s{rank}`), and the dirs empty
after close.
"""
import dataclasses
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
ARMS = ("fused", "eager", "sync", "serial", "resumed")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    from repro_torch.core.tree import tree_flatten
    return [t.detach().clone().cpu() for t in tree_flatten(tree)[0]]


def _rank_runs(rank: int, d: str, params) -> dict:
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.configs.paper_models import small_gpt
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.comm import init_mesh
    from repro_torch.session import TrainSession

    cfg = dataclasses.replace(small_gpt(128, 2), dtype="float32")
    mesh = init_mesh((2, 2), ("data", "model"), device="cpu")
    settings = RunSettings(attn_impl="torch", attn_chunk=32,
                           activation_policy="keep", param_dtype="float32",
                           device="cpu")
    out = {}

    def session(name, *, overlap=None, host_offload="none", ckpt=None):
        io = SpoolIoConfig(backend="fs", directory=os.path.join(d, name),
                           host_offload=host_offload)
        return TrainSession(cfg, engine="jit", device="cpu", io=io,
                            settings=settings,
                            optimizer=adamw(LR, clip_norm=None),
                            batch_size=B, seq_len=S, seed=SEED,
                            min_offload_elements=MIN_OFF, mesh=mesh,
                            opt_overlap=overlap, ckpt_dir=ckpt, ckpt_every=0)

    def record(name, s, losses, leases=()):
        bridge = s.opt_bridge
        st = bridge.materialize() if bridge is not None else s.opt_state
        out[name] = {"losses": losses, "params": _host(s.params),
                     "mu": _host(st.mu), "nu": _host(st.nu),
                     "step": int(st.step),
                     "leases": sorted(set(leases) | set(
                         bridge.lease_ids() if bridge else ()))}

    for name, overlap in (("fused", None), ("eager", True),
                          ("sync", "sync")):
        with session(name, overlap=overlap) as s:
            s.set_params(params)
            record(name, s, s.run(STEPS).losses)
    staged = []
    with session("serial", host_offload="opt_state") as s:
        s.set_params(params)
        res = s.run(STEPS, on_report=lambda rep: staged.append(
            s._loop._opt_tx.step_id))
        record("serial", s, res.losses, staged)
    ck = os.path.join(d, "ckpt")
    with session("resumed", overlap=True, ckpt=ck) as s:
        s.set_params(params)
        first = s.run(STEPS - 1).losses
    with session("resumed", overlap=True, ckpt=ck) as s:
        record("resumed", s, first + s.run(1, resume=True).losses)
    for name in ARMS:
        out[name]["left"] = sorted(os.listdir(os.path.join(d, name)))
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


def _jax_losses(params_out):
    import jax
    from repro.configs.paper_models import small_gpt as jsmall
    from repro.models.api import build_model
    from repro.models.transformer import RunSettings as JSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession

    cfg = dataclasses.replace(jsmall(128, 2), dtype="float32")
    settings = JSettings(attn_impl="xla", attn_chunk=32,
                         activation_policy="keep", param_dtype="float32")
    params_out.append(jax.tree.map(
        np.asarray, build_model(cfg).init(jax.random.key(SEED))))
    with JSession(cfg, engine="jit", settings=settings,
                  optimizer=jopt.adamw(LR, clip_norm=None), lr=LR,
                  batch_size=B, seq_len=S, seed=SEED, ckpt_every=0,
                  min_offload_elements=MIN_OFF) as s:
        return s.run(STEPS).losses


@pytest.fixture(scope="module")
def overlap_runs(tmp_path_factory):
    pytest.importorskip("jax")
    d = str(tmp_path_factory.mktemp("mesh_overlap"))
    for name in ARMS:
        os.makedirs(os.path.join(d, name))
    got = []
    ref = _jax_losses(got)
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
    return {"ranks": ranks, "jax": ref}


@pytest.mark.parametrize("arm", ["eager", "sync", "serial", "resumed"])
def test_every_arm_is_bitwise_the_fused_update(overlap_runs, arm):
    for res in overlap_runs["ranks"]:
        want, got = res["fused"], res[arm]
        assert got["losses"] == want["losses"]
        assert got["step"] == want["step"] == STEPS
        for part in ("params", "mu", "nu"):
            assert len(got[part]) == len(want[part]) > 0
            for a, b in zip(got[part], want[part]):
                assert torch.equal(a, b), part


@pytest.mark.parametrize("arm", ARMS)
def test_losses_match_the_jax_single_device_session(overlap_runs, arm):
    for res in overlap_runs["ranks"]:
        np.testing.assert_allclose(res[arm]["losses"], overlap_runs["jax"],
                                   rtol=1e-4)


@pytest.mark.parametrize("arm", ["eager", "sync", "serial"])
def test_the_ranks_opt_leases_are_named_apart(overlap_runs, arm):
    seen = set()
    for rank, res in enumerate(overlap_runs["ranks"]):
        leases = res[arm]["leases"]
        assert leases and all(x.startswith("opt") and
                              x.endswith(f"/s{rank}") for x in leases)
        assert not seen & set(leases)
        seen |= set(leases)


@pytest.mark.parametrize("arm", ARMS)
def test_spool_dirs_are_empty_after_close(overlap_runs, arm):
    for res in overlap_runs["ranks"]:
        assert res[arm]["left"] == [], res[arm]["left"]
