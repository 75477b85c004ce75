"""Checkpoints of a mesh: one module-scoped spawn of 4 gloo ranks on the
CPU, the paper's small GPT (`small_gpt(128, 2)`, f32, adamw lr 1e-3 with
its clip, batch 4, seq 32, seed 3) on the JAX init's weights
(`TrainSession.set_params`). The ranks first form one world of 4:

  one       rank 0 alone, one device: 2 steps, a checkpoint at step 2;
  full      a (2, 2) ("data", "model") mesh, 3 steps, no checkpoint;
  save      the same mesh, 2 steps, its final checkpoint at step 2 (the
            logical arrays, gathered over the ranks, written by rank 0);
  same      a fresh (2, 2) session resumes that checkpoint (its shards
            recorded after the restore) and runs step 3;
  from_one  a (2, 2) session resumes the one-device checkpoint;
  from_jax  a (2, 2) session resumes a checkpoint the JAX package wrote
            from one device (the JAX init and one adamw update).

Then the world splits in two: ranks 0-1 resume `save`'s checkpoint on a
(1, 2) mesh and ranks 2-3 on a (2, 1) mesh, each recording its shards
after the restore and running step 3. The parent resumes it on one
device, and reads it with the JAX package's `restore_checkpoint`. Each
resume reads its own copy of the checkpoint.

The tests: every restored shard bitwise equal to the stored logical
array cut by `param_specs` (moments too: ZeRO-1), the same-mesh resume
bitwise equal to the uninterrupted run in losses and parameters, the
resumes on (1, 2), (2, 1) and one device within 1e-4 of its step-3 loss,
JAX's reader equal to the saving ranks' shards, and the data cursor and
step carried.
"""
import dataclasses
import os
import pickle
import shutil
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_one_thread import one_torch_thread  # noqa: E402,F401

B, S, SEED, LR = 4, 32, 3, 1e-3
WORLD = 4
PAIRS = {"tp": (1, 2), "dp": (2, 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg():
    from repro_torch.configs.paper_models import small_gpt
    return dataclasses.replace(small_gpt(128, 2), dtype="float32")


def _session(mesh, ckpt_dir=None):
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import adamw
    from repro_torch.session import TrainSession
    return TrainSession(
        _cfg(), engine="jit", device="cpu", optimizer=adamw(LR),
        settings=RunSettings(attn_impl="torch", attn_chunk=32,
                             activation_policy="keep",
                             param_dtype="float32", device="cpu"),
        batch_size=B, seq_len=S, seed=SEED, mesh=mesh, ckpt_dir=ckpt_dir,
        ckpt_every=0)


def _state(s):
    """The session's train state, (key, host array or int) pairs."""
    from repro_torch.ckpt.checkpoint import flatten_with_paths
    return [(k, v.detach().clone().numpy() if isinstance(v, torch.Tensor)
             else v) for k, v in flatten_with_paths(
                 {"params": s.params, "opt_state": s.opt_state})]


def _resume(mesh, ckpt_dir, steps):
    """Restore the latest checkpoint of `ckpt_dir` (shards recorded), then
    run `steps` steps."""
    with _session(mesh, ckpt_dir) as s:
        s.run(0, resume=True)
        rec = {"restored": _state(s), "step": s.step,
               "coords": dict(mesh.coords) if mesh else None,
               "shape": dict(mesh.shape) if mesh else None}
        if steps:
            rec["losses"] = s.run(steps).losses
            rec["final"] = _state(s)
    return rec


def _phase_world(rank, d, params):
    from repro_torch.parallel.comm import init_mesh
    mesh = init_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    if rank == 0:
        with _session(None, os.path.join(d, "one")) as s:
            s.set_params(params)
            out["one"] = {"losses": s.run(2).losses}
    mesh.comm.barrier()
    with _session(mesh) as s:
        s.set_params(params)
        out["full"] = {"losses": s.run(3).losses, "final": _state(s),
                       "coords": dict(mesh.coords)}
    with _session(mesh, os.path.join(d, "save")) as s:
        s.set_params(params)
        out["save"] = {"losses": s.run(2).losses, "final": _state(s),
                       "coords": dict(mesh.coords),
                       "snapshot_s": s.ckpt.last_snapshot_s}
    if rank == 0:
        for copy in ("same", "tp", "dp", "parent"):
            shutil.copytree(os.path.join(d, "save"),
                            os.path.join(d, copy))
        for src in ("one", "jax"):
            shutil.copytree(os.path.join(d, src),
                            os.path.join(d, f"{src}_mesh"))
    mesh.comm.barrier()
    out["same"] = _resume(mesh, os.path.join(d, "same"), 1)
    out["from_one"] = _resume(mesh, os.path.join(d, "one_mesh"), 0)
    out["from_jax"] = _resume(mesh, os.path.join(d, "jax_mesh"), 0)
    return out


def _worker(rank, ports, d, params_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{ports[0]}", rank=rank,
            world_size=WORLD)
        with open(params_path, "rb") as f:
            params = pickle.load(f)
        out = _phase_world(rank, d, params)
        dist.destroy_process_group()
        # two worlds of two: (1, 2) on ranks 0-1, (2, 1) on ranks 2-3
        from repro_torch.parallel.comm import init_mesh
        name = "tp" if rank < 2 else "dp"
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{ports[1 + rank // 2]}",
            rank=rank % 2, world_size=2)
        mesh = init_mesh(PAIRS[name], ("data", "model"), device="cpu")
        out[name] = _resume(mesh, os.path.join(d, name), 1)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_tree():
    """The JAX init (numpy) and a one-device JAX train state after one
    adamw update on seeded gradients."""
    import jax
    import jax.numpy as jnp
    from repro.configs.paper_models import small_gpt as jsmall
    from repro.models.api import build_model
    from repro.optim import optimizers as jopt
    cfg = dataclasses.replace(jsmall(128, 2), dtype="float32")
    params = build_model(cfg).init(jax.random.key(SEED))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)
    opt = jopt.adamw(LR)
    new, state = opt.update(grads, opt.init(params), params)
    return (jax.tree.map(np.asarray, params),
            {"params": new, "opt_state": state})


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    pytest.importorskip("jax")
    from repro.ckpt import checkpoint as jckpt
    d = str(tmp_path_factory.mktemp("mesh_ckpt"))
    params, jtree = _jax_tree()
    jckpt.save_checkpoint(os.path.join(d, "jax"), 1, jtree)
    params_path = os.path.join(d, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    ports = [_free_port() for _ in range(3)]
    mp.start_processes(_worker, args=(ports, d, params_path),
                       nprocs=WORLD, start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    parent = _resume(None, os.path.join(d, "parent"), 1)
    return {"ranks": ranks, "dir": d, "jtree": jtree, "parent": parent,
            "specs": {name: _specs(shape, params) for name, shape in (
                ("2x2", (2, 2)),) + tuple(PAIRS.items())}}


# ------------------------------------------------------------ helpers

def _logical(path, step):
    """The stored arrays of a checkpoint step by leaf key."""
    p = os.path.join(path, f"step_{step:08d}", "arrays.npz")
    with np.load(p) as data:
        return {k.replace("|", "/"): data[k] for k in data.files}


def _specs(shape, params):
    """Leaf key (without its "params/" prefix) -> spec, by `param_specs`
    over a stub ("data", "model") mesh of `shape`."""
    from repro_torch.parallel.mesh import make_test_mesh
    from repro_torch.parallel.sharding import (default_axes, map_with_path,
                                               param_specs)
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    map_with_path(lambda path, spec: out.__setitem__("/".join(path), spec),
                  param_specs(_cfg(), params, mesh, default_axes(mesh)))
    return out


def _cut(arr, spec, coords, shape):
    """`arr`'s block at `coords` as `spec` shards it (row major over each
    entry's axes)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = 1, 0
        for a in entry if isinstance(entry, tuple) else (entry,):
            n, i = n * shape[a], i * shape[a] + coords[a]
        size = arr.shape[dim] // n
        arr = np.take(arr, range(i * size, (i + 1) * size), axis=dim)
    return arr


def _spec_of(specs, key):
    for pre in ("params/", "opt_state/.mu/", "opt_state/.nu/"):
        if key.startswith(pre):
            return specs[key[len(pre):]]
    return ()


def _assert_shards_of(state, logical, coords, shape, specs=None):
    assert [k for k, _ in state] == list(logical)
    for key, got in state:
        want = logical[key]
        if shape:
            want = _cut(want, _spec_of(specs, key), coords, shape)
        if isinstance(got, int):
            assert got == int(want), key
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), key


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("source,run", [
    ("save", "same"), ("save", "tp"), ("save", "dp"), ("one", "from_one"),
    ("jax", "from_jax")])
def test_restored_shards_are_the_logical_arrays_cut_by_the_specs(
        ckpt_runs, source, run):
    step = 1 if source == "jax" else 2
    logical = _logical(os.path.join(ckpt_runs["dir"], source), step)
    seen = 0
    for res in ckpt_runs["ranks"]:
        if run in res:
            rec = res[run]
            assert rec["step"] == step
            _assert_shards_of(rec["restored"], logical, rec["coords"],
                              rec["shape"], ckpt_runs["specs"][
                                  "2x2" if run in ("same", "from_one",
                                                   "from_jax") else run])
            seen += 1
    assert seen == (2 if run in ("tp", "dp") else WORLD)


def test_a_one_device_restore_of_a_mesh_save_is_its_logical_arrays(
        ckpt_runs):
    logical = _logical(os.path.join(ckpt_runs["dir"], "save"), 2)
    _assert_shards_of(ckpt_runs["parent"]["restored"], logical, None, None)


def test_the_saved_arrays_are_the_ranks_shards(ckpt_runs):
    """Each saving rank's state at step 2 is its cut of the logical
    arrays rank 0 wrote: the gather put every shard in its place."""
    logical = _logical(os.path.join(ckpt_runs["dir"], "save"), 2)
    for res in ckpt_runs["ranks"]:
        _assert_shards_of(res["save"]["final"], logical,
                          res["save"]["coords"], {"data": 2, "model": 2},
                          ckpt_runs["specs"]["2x2"])


def test_the_jax_package_reads_a_mesh_checkpoint_bitwise(ckpt_runs):
    import jax
    from repro.ckpt import checkpoint as jckpt
    d = os.path.join(ckpt_runs["dir"], "save")
    got, manifest = jckpt.restore_checkpoint(d, ckpt_runs["jtree"])
    assert manifest["step"] == 2 and manifest["metadata"]["final"]
    assert manifest["metadata"]["data"]      # the data cursor rides along
    leaves = jax.tree.leaves(got)
    logical = _logical(d, 2)
    assert len(leaves) == len(logical)
    for leaf, (key, want) in zip(leaves, logical.items()):
        leaf = np.asarray(leaf)
        assert leaf.dtype == want.dtype and np.array_equal(
            leaf.reshape(-1).view(np.uint8),
            want.reshape(-1).view(np.uint8)), key


def test_a_same_mesh_resume_is_bitwise_the_uninterrupted_run(ckpt_runs):
    for res in ckpt_runs["ranks"]:
        full = res["full"]
        assert res["save"]["losses"] == full["losses"][:2]
        assert res["same"]["losses"] == full["losses"][2:]
        assert [k for k, _ in res["same"]["final"]] == \
            [k for k, _ in full["final"]]
        for (key, got), (_, want) in zip(res["same"]["final"],
                                         full["final"]):
            if isinstance(want, int):
                assert got == want, key
            else:
                assert np.array_equal(got, want), key


@pytest.mark.parametrize("run", ["tp", "dp", "parent"])
def test_a_resume_on_another_mesh_stays_within_1e4(ckpt_runs, run):
    want = ckpt_runs["ranks"][0]["full"]["losses"][2:]
    recs = ([ckpt_runs["parent"]] if run == "parent" else
            [res[run] for res in ckpt_runs["ranks"] if run in res])
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-4)


def test_the_one_device_save_trains_as_the_mesh(ckpt_runs):
    one = ckpt_runs["ranks"][0]["one"]["losses"]
    np.testing.assert_allclose(one, ckpt_runs["ranks"][0]["full"]["losses"]
                               [:2], rtol=1e-4)


def test_only_the_writer_writes_and_every_rank_gathers(ckpt_runs):
    d = os.path.join(ckpt_runs["dir"], "save")
    assert sorted(os.listdir(d)) == ["step_00000002"]
    for res in ckpt_runs["ranks"]:
        assert res["save"]["snapshot_s"] > 0
