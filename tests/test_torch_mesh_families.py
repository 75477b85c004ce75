"""hubert-xlarge and llama-3.2-vision-90b trained on a mesh: one
module-scoped spawn of 2 gloo ranks on the CPU. Each family runs at
`:reduced` in f32 with sgd on the JAX init's weights
(`TrainSession.set_params`) and the batches of its loader
(`data.pipeline.embedding_batches` / `vision_batches`), on a (1, 2)
("data", "model") mesh (tp=2: hubert's `frontend_proj` column-parallel,
its width gathered; the vision model's cross block column-parallel over
the patch embeddings, `wo` row-parallel) and on a (2, 1) mesh (dp=2,
fsdp + ZeRO-1), each kept and with `host_offload="activations"` (fs, one
directory the ranks share).

Separate tests read the results: losses within rtol 1e-4 of the JAX
single-device jit session, spooled bitwise equal to kept on the same
mesh, every layer stage stored and fetched once a step by each shard,
each shard storing on the tensor axis what it stores on the data axis
(the tensors replicated over the tensor axis, the normed inputs the
projections read, go to the spool as 1/tp slices, and the patch
embeddings `enc`, a graph leaf, are stored by neither mesh), and empty
spool dirs after close.
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

STEPS, B, S, SEED, LR, MIN_OFF = 2, 4, 32, 3, 1e-2, 256
WORLD = 2
ARCHS = ("hubert-xlarge:reduced", "llama-3.2-vision-90b:reduced")
MESHES = {"tp": (1, 2), "dp": (2, 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _loader(cfg):
    from repro_torch.data.pipeline import embedding_batches, vision_batches
    if cfg.input_kind == "embeddings":
        return embedding_batches(cfg.d_model, cfg.vocab_size, batch=B,
                                 seq_len=S, seed=SEED)
    return vision_batches(cfg.vocab_size, cfg.d_model, cfg.encoder_seq_len,
                          batch=B, seq_len=S, seed=SEED)


def _tcfg(arch):
    from repro_torch.configs import resolve_config
    return dataclasses.replace(resolve_config(arch), dtype="float32")


def _rank_runs(rank: int, d: str, params) -> dict:
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    from repro_torch.parallel.comm import init_mesh
    from repro_torch.session import TrainSession

    out = {}
    for mname, shape in MESHES.items():
        mesh = init_mesh(shape, ("data", "model"), device="cpu")
        for arch in ARCHS:
            cfg = _tcfg(arch)
            for spooled in (False, True):
                sub = os.path.join(d, f"{mname}_{arch.split('-')[0]}")
                io = SpoolIoConfig(backend="fs", directory=sub,
                                   host_offload="activations") \
                    if spooled else None
                settings = None if spooled else RunSettings(
                    attn_impl="torch", attn_chunk=32,
                    activation_policy="keep", param_dtype="float32",
                    device="cpu")
                with TrainSession(cfg, engine="jit", device="cpu", io=io,
                                  settings=settings, optimizer=sgd(LR),
                                  batch_size=B, seq_len=S, seed=SEED,
                                  loader=_loader(cfg),
                                  min_offload_elements=MIN_OFF,
                                  mesh=mesh) as s:
                    s.set_params(params[arch])
                    res = s.run(STEPS)
                    rec = {"losses": res.losses,
                           "shards": s.shard_totals(),
                           "params": [t.clone() for t in
                                      _leaves(s.params)]}
                if spooled:
                    rec["left"] = sorted(os.listdir(sub))
                out[(mname, arch, spooled)] = rec
    return out


def _leaves(tree):
    from repro_torch.core.tree import tree_flatten
    return tree_flatten(tree)[0]


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


def _jax_run(arch):
    """The JAX single-device jit session's losses, and its init weights
    as numpy arrays."""
    import jax
    from repro.session.session import resolve_config as jresolve
    from repro.models.api import build_model
    from repro.models.transformer import RunSettings as JSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession

    jcfg = dataclasses.replace(jresolve(arch), dtype="float32")
    settings = JSettings(attn_impl="xla", attn_chunk=32,
                         activation_policy="keep", param_dtype="float32")
    params = jax.tree.map(np.asarray,
                          build_model(jcfg).init(jax.random.key(SEED)))
    with JSession(jcfg, engine="jit", settings=settings,
                  optimizer=jopt.sgd(LR), lr=LR, batch_size=B, seq_len=S,
                  seed=SEED, ckpt_every=0, loader=_loader(_tcfg(arch)),
                  min_offload_elements=MIN_OFF) as s:
        return s.run(STEPS).losses, params


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    pytest.importorskip("jax")
    d = str(tmp_path_factory.mktemp("mesh_families"))
    ref, params = {}, {}
    for arch in ARCHS:
        ref[arch], params[arch] = _jax_run(arch)
    for mname in MESHES:
        for arch in ARCHS:
            os.makedirs(os.path.join(d, f"{mname}_{arch.split('-')[0]}"))
    params_path = os.path.join(d, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    mp.start_processes(_worker, args=(_free_port(), d, params_path),
                       nprocs=WORLD, start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    return {"ranks": ranks, "jax": ref}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_the_jax_single_device_session(family_runs, arch, mesh):
    for res in family_runs["ranks"]:
        for spooled in (False, True):
            np.testing.assert_allclose(res[(mesh, arch, spooled)]["losses"],
                                       family_runs["jax"][arch], rtol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spooled_is_bitwise_equal_to_kept(family_runs, arch, mesh):
    for res in family_runs["ranks"]:
        kept, spooled = res[(mesh, arch, False)], res[(mesh, arch, True)]
        assert spooled["losses"] == kept["losses"]
        assert len(spooled["params"]) == len(kept["params"])
        for a, b in zip(spooled["params"], kept["params"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_shard_stores_and_fetches_every_layer_stage(family_runs, arch,
                                                         mesh):
    layers = _tcfg(arch)
    stages = (layers.num_layers // layers.cross_attn_period
              if layers.cross_attn_period else layers.num_layers)
    shards = family_runs["ranks"][0][(mesh, arch, True)]["shards"]
    assert sorted(shards) == ["0", "1"]
    for v in shards.values():
        assert v["offloads"] == v["fetches"] == stages * STEPS
        assert v["replica_skips"] == 0
        assert v["bytes_in"] == v["bytes_out"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_axis_shards_store_replicated_tensors_as_slices(family_runs,
                                                              arch):
    """A tp=2 shard stores half of every tensor a layer stage saves (its
    heads' and its d_ff's share, a 1/tp slice of the replicated ones); a
    dp=2 shard stores all of them for half the rows: the same bytes. The
    patch embeddings are stored by neither (on a tensor axis a full copy
    would make the tp shards store more)."""
    res = family_runs["ranks"][0]
    tp = res[("tp", arch, True)]["shards"]
    dp = res[("dp", arch, True)]["shards"]
    assert [v["bytes_in"] for _, v in sorted(tp.items())] == \
        [v["bytes_in"] for _, v in sorted(dp.items())]


def test_every_rank_reports_the_same_losses(family_runs):
    first, other = family_runs["ranks"]
    for key, rec in first.items():
        assert other[key]["losses"] == rec["losses"], key


def test_spool_dirs_are_empty_after_close(family_runs):
    for res in family_runs["ranks"]:
        for key, rec in res.items():
            if key[2]:
                assert rec["left"] == [], (key, rec["left"])
