"""mamba2, recurrentgemma and T5 trained on a mesh: one module-scoped
spawn of 2 gloo ranks on the CPU. Each family runs in f32 with sgd on
the JAX init's weights (`TrainSession.set_params`): mamba2-2.7b:reduced
(8 SSM heads, 4 a rank at tp=2), recurrentgemma-9b:reduced at 3 layers
(one period: rglru, rglru and the MQA block; the RG-LRU width 64, 32 a
rank) and `small_t5()` (its encoder stream, then the decoder's with its
cross blocks), on a (1, 2) ("data", "model") mesh and on a (2, 1) mesh
(fsdp + ZeRO-1), each kept and with `host_offload="activations"` (fs,
one directory the ranks share).

Separate tests read the results: losses within rtol 1e-4 of the JAX
single-device jit session, spooled bitwise equal to kept on the same
mesh, every layer stage stored and fetched once a step by each shard,
the tensors replicated over the tensor axis stored as 1/tp slices, and
empty spool dirs after close. The same ranks check the two collectives
the recurrent blocks add (the gated norm's sum of squares, all-reduced
both ways; the all-gather whose backward reduce-scatters) against one
rank's whole computation, round-trip mamba2's concatenated leaves
through their layout (`parallel/sharding.py::layout_specs`), and write a
checkpoint of the (1, 2) mamba2 run after step 1, which the parent
restores onto one device for step 2 and the JAX package reads.
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
ARCHS = ("mamba2-2.7b:reduced", "recurrentgemma-9b:reduced", "small-t5")
MESHES = {"tp": (1, 2), "dp": (2, 1)}
CKPT_ARCH = ARCHS[0]
# the layer stages of each family: mamba2's 2 layers, recurrentgemma's
# one period of 3 blocks, T5's 2 encoder and 2 decoder layers
STAGES = {ARCHS[0]: 2, ARCHS[1]: 1, ARCHS[2]: 4}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tcfg(arch):
    from repro_torch.configs import resolve_config, small_t5
    cfg = small_t5() if arch == "small-t5" else resolve_config(arch)
    if arch.startswith("recurrentgemma"):
        cfg = dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, dtype="float32")


def _loader(cfg):
    from repro_torch.data.pipeline import encoder_decoder_batches
    if cfg.family == "encdec":
        return encoder_decoder_batches(cfg.vocab_size, batch=B, seq_len=S,
                                       seed=SEED)
    return None


def _session(cfg, mesh, io=None, ckpt_dir=None):
    from repro_torch.models.transformer import RunSettings
    from repro_torch.optim.optimizers import sgd
    from repro_torch.session import TrainSession
    settings = None if io is not None else RunSettings(
        attn_impl="torch", attn_chunk=32, activation_policy="keep",
        param_dtype="float32", device="cpu")
    return TrainSession(cfg, engine="jit", device="cpu", io=io,
                        settings=settings, optimizer=sgd(LR), batch_size=B,
                        seq_len=S, seed=SEED, loader=_loader(cfg),
                        min_offload_elements=MIN_OFF, mesh=mesh,
                        ckpt_dir=ckpt_dir, ckpt_every=0)


def _leaves(tree):
    from repro_torch.core.tree import tree_flatten
    return tree_flatten(tree)[0]


def _pack_spy(log):
    """`MeshRun.pack` recording, for each tensor a stage saves, its shape,
    whether it is replicated over the tensor axis, and the elements it
    saved and stored."""
    from repro_torch.core.meshrun import MeshRun
    real = MeshRun.pack

    def pack(self, saved, flags):
        packed, cuts = real(self, saved, flags)
        log.extend((tuple(t.shape), bool(f), t.numel(), p.numel())
                   for t, f, p in zip(saved, flags, packed))
        return packed, cuts
    return real, pack


def _rank_runs(d, params) -> dict:
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.meshrun import MeshRun
    from repro_torch.parallel.comm import init_mesh

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
                log = []
                real, spy = _pack_spy(log)
                MeshRun.pack = spy
                try:
                    with _session(cfg, mesh, io) as s:
                        s.set_params(params[arch])
                        res = s.run(STEPS)
                        rec = {"losses": res.losses,
                               "shards": s.shard_totals(),
                               "params": [t.clone() for t in
                                          _leaves(s.params)]}
                finally:
                    MeshRun.pack = real
                if spooled:
                    rec["left"] = sorted(os.listdir(sub))
                    rec["packed"] = log
                out[(mname, arch, spooled)] = rec
        if mname == "tp":
            out["collectives"] = _collectives(mesh)
            out["layout"] = _layout_round_trip(mesh, params[CKPT_ARCH])
            with _session(_tcfg(CKPT_ARCH), mesh,
                          ckpt_dir=os.path.join(d, "ckpt")) as s:
                s.set_params(params[CKPT_ARCH])
                out["ckpt_losses"] = s.run(1).losses
    return out


def _collectives(mesh) -> dict:
    """Each new collective's gradients on this rank beside those of one
    rank computing the whole, from the same f64 inputs."""
    from repro_torch.models.mamba2 import _gated_norm
    from repro_torch.parallel.comm import axis_group
    tp = axis_group(mesh, "model")
    rng = np.random.default_rng(7)
    y, z, w = (torch.tensor(rng.standard_normal((2, 5, 8)))
               for _ in range(3))
    scale = torch.tensor(rng.standard_normal(8))
    mine = slice(tp.rank * 4, tp.rank * 4 + 4)
    out = {}

    def grads(fn, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        fn(*xs).backward()
        return [x.grad for x in xs]

    whole = grads(lambda y, z, s: (_gated_norm(y, z, s, 1e-6).double()
                                   * w).sum(), y, z, scale)
    part = grads(lambda y, z, s: (_gated_norm(y, z, s, 1e-6, tp).double()
                                  * w[..., mine]).sum(),
                 y[..., mine], z[..., mine], scale[mine])
    out["norm"] = [(p, g[..., mine]) for p, g in zip(part, whole)]
    u, c = (torch.tensor(rng.standard_normal((2, 5, 8))) for _ in range(2))
    wm, g = torch.tensor(rng.standard_normal((8, 8))), \
        torch.tensor(rng.standard_normal((2, 5, 8)))
    whole = grads(lambda u: ((u @ wm) * g).sum() + (u * c).sum(), u)
    part = grads(lambda u: ((tp.gather_partial(u, 2) @ wm[:, mine])
                            * g[..., mine]).sum()
                 + (u * c[..., mine]).sum(), u[..., mine])
    out["gather"] = [(part[0], whole[0][..., mine])]
    return out


def _layout_round_trip(mesh, params) -> dict:
    """mamba2's concatenated leaves cut onto this rank's shard by the
    port's layout and gathered back."""
    from repro_torch.core.meshrun import cut_leaf, gather_leaf, wrap_specs
    from repro_torch.parallel.sharding import default_axes, layout_specs
    cfg = _tcfg(CKPT_ARCH)
    specs = wrap_specs(layout_specs(cfg, params, mesh, default_axes(mesh)))
    out = {}
    for path in (("w_zx",), ("w_bc",), ("conv", "w")):
        leaf = params["segments"][0]["b0"]["ssm"]
        spec = specs["segments"][0]["b0"]["ssm"]
        for k in path:
            leaf, spec = leaf[k], spec[k]
        shard = cut_leaf(torch.from_numpy(leaf), spec, mesh)
        out["/".join(path)] = (shard.clone(),
                               gather_leaf(shard, spec, mesh).numpy())
    return out


def _worker(rank, port, d, params_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        with open(params_path, "rb") as f:
            params = pickle.load(f)
        out = _rank_runs(d, params)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_cfg(arch):
    from repro.configs.paper_models import small_t5 as jsmall_t5
    from repro.session.session import resolve_config as jresolve
    cfg = jsmall_t5() if arch == "small-t5" else jresolve(arch)
    if arch.startswith("recurrentgemma"):
        cfg = dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, dtype="float32")


def _jax_run(arch):
    """The JAX single-device jit session's losses (3 steps: step 2's
    after a one-device restore), and its init weights as numpy arrays."""
    import jax
    from repro.models.api import build_model
    from repro.models.transformer import RunSettings as JSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession

    jcfg = _jax_cfg(arch)
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
def recurrent_runs(tmp_path_factory):
    pytest.importorskip("jax")
    import jax
    from repro.ckpt import checkpoint as jckpt
    from repro.optim import optimizers as jopt
    d = str(tmp_path_factory.mktemp("mesh_recurrent"))
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
    # the JAX package reads the (1, 2) checkpoint of step 1 ...
    ck = os.path.join(d, "ckpt")
    jparams = params[CKPT_ARCH]
    jtree = {"params": jparams, "opt_state": jopt.sgd(LR).init(jparams)}
    got, manifest = jckpt.restore_checkpoint(ck, jtree)
    jax_read = {"step": manifest["step"],
                "leaves": [np.asarray(t) for t in jax.tree.leaves(got)],
                "params": [np.asarray(t)
                           for t in jax.tree.leaves(got["params"])]}
    # ... and one device resumes it for step 2
    with _session(_tcfg(CKPT_ARCH), None, ckpt_dir=ck) as s:
        s.run(0, resume=True)
        one = {"step": s.step, "losses": s.run(1).losses}
    return {"ranks": ranks, "jax": ref, "params": params, "dir": d,
            "jax_read": jax_read, "one_device": one}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_the_jax_single_device_session(recurrent_runs, arch,
                                                    mesh):
    for res in recurrent_runs["ranks"]:
        for spooled in (False, True):
            np.testing.assert_allclose(res[(mesh, arch, spooled)]["losses"],
                                       recurrent_runs["jax"][arch],
                                       rtol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spooled_is_bitwise_equal_to_kept(recurrent_runs, arch, mesh):
    for res in recurrent_runs["ranks"]:
        kept, spooled = res[(mesh, arch, False)], res[(mesh, arch, True)]
        assert spooled["losses"] == kept["losses"]
        assert len(spooled["params"]) == len(kept["params"])
        for a, b in zip(spooled["params"], kept["params"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_shard_stores_and_fetches_every_layer_stage(recurrent_runs,
                                                         arch, mesh):
    shards = recurrent_runs["ranks"][0][(mesh, arch, True)]["shards"]
    assert sorted(shards) == ["0", "1"]
    for v in shards.values():
        assert v["offloads"] == v["fetches"] == STAGES[arch] * STEPS
        assert v["replica_skips"] == 0
        assert v["bytes_in"] == v["bytes_out"] > 0


def test_every_rank_reports_the_same_losses(recurrent_runs):
    first, other = recurrent_runs["ranks"]
    for key, rec in first.items():
        if isinstance(key, tuple):
            assert other[key]["losses"] == rec["losses"], key


def test_spool_dirs_are_empty_after_close(recurrent_runs):
    for res in recurrent_runs["ranks"]:
        for key, rec in res.items():
            if isinstance(key, tuple) and key[2]:
                assert rec["left"] == [], (key, rec["left"])


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_axis_shards_store_replicated_tensors_as_slices(
        recurrent_runs, arch):
    """On the tensor axis every tensor a layer stage saves that is the
    same on both ranks goes to the spool as a 1/tp slice, the rest whole:
    among the former the normed input of each block (the parallel
    region's input) and, in recurrentgemma, the whole RG-LRU input the
    gates read (gathered over the axis)."""
    cfg = _tcfg(arch)
    for res in recurrent_runs["ranks"]:
        rec = res[("tp", arch, True)]
        rep = [r for r in rec["packed"] if r[1]]
        assert rep and all(stored * 2 == saved for _, _, saved, stored
                           in rep)
        assert all(stored == saved for _, f, saved, stored in rec["packed"]
                   if not f)
        assert sum(r[3] for r in rec["packed"]) < \
            sum(r[2] for r in rec["packed"])
        # autograd saves a product's (B, S, D) input as (B * S, D)
        sizes = {saved for _, _, saved, _ in rep}
        assert B * S * cfg.d_model in sizes, sorted(r[0] for r in rep)
        if arch.startswith("recurrentgemma"):
            assert (B, S, cfg.rglru_width) in {r[0] for r in rep}


def test_the_new_collectives_match_one_rank_computing_the_whole(
        recurrent_runs):
    """The gated norm's sum of squares (all-reduced forward and backward)
    and the all-gather whose backward reduce-scatters: each rank's
    gradients are its slice of one rank's whole computation's (the norm
    computes in f32)."""
    for res in recurrent_runs["ranks"]:
        for name, pairs in res["collectives"].items():
            for got, want in pairs:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=name)


def test_mamba2_leaves_round_trip_through_their_layout(recurrent_runs):
    """w_zx (z | x), the conv weight (x | B | C) and w_bc cut onto the
    (1, 2) mesh and gathered back are bitwise the logical arrays; a rank
    holds z and x of its own heads, its x channels beside B and C whole,
    and w_bc whole."""
    ssm = recurrent_runs["params"][CKPT_ARCH]["segments"][0]["b0"]["ssm"]
    inner = ssm["w_zx"].shape[-1] // 2
    half = inner // 2
    for r, res in enumerate(recurrent_runs["ranks"]):
        mine = slice(r * half, (r + 1) * half)
        zx, conv = ssm["w_zx"], ssm["conv"]["w"]
        for key, want in (
                ("w_zx", np.concatenate([zx[..., :inner][..., mine],
                                         zx[..., inner:][..., mine]],
                                        axis=-1)),
                ("w_bc", ssm["w_bc"]),
                ("conv/w", np.concatenate([conv[..., mine],
                                           conv[..., inner:]], axis=-1))):
            shard, whole = res["layout"][key]
            assert np.array_equal(shard.numpy(), want), key
            logical = ssm
            for k in key.split("/"):
                logical = logical[k]
            assert whole.dtype == logical.dtype and np.array_equal(
                whole, logical), key


def test_a_mesh_checkpoint_restores_onto_one_device(recurrent_runs):
    """The (1, 2) mamba2 run's checkpoint after step 1, restored onto one
    device, takes step 2 within 1e-4 of the JAX session's."""
    one = recurrent_runs["one_device"]
    assert one["step"] == 1
    np.testing.assert_allclose(one["losses"],
                               recurrent_runs["jax"][CKPT_ARCH][1:],
                               rtol=1e-4)
    for res in recurrent_runs["ranks"]:
        assert res["ckpt_losses"] == res[("tp", CKPT_ARCH, False)][
            "losses"][:1]


def test_the_jax_package_reads_the_mesh_checkpoint(recurrent_runs):
    """The JAX reader takes the logical arrays rank 0 wrote, bitwise,
    each of the JAX init's shape."""
    import jax
    got = recurrent_runs["jax_read"]
    assert got["step"] == 1
    p = os.path.join(recurrent_runs["dir"], "ckpt", "step_00000001",
                     "arrays.npz")
    with np.load(p) as data:
        stored = [data[k] for k in data.files]
    params = jax.tree.leaves(recurrent_runs["params"][CKPT_ARCH])
    assert len(got["leaves"]) == len(stored)
    for leaf, want in zip(got["leaves"], stored):
        assert leaf.dtype == want.dtype and np.array_equal(leaf, want)
    assert [t.shape for t in got["params"]] == [t.shape for t in params]


def test_layout_specs_lay_out_only_mamba2_on_a_tensor_axis():
    """`layout_specs` is `param_specs` but for mamba2's three
    concatenated leaves on a tensor axis of more than one rank."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.api import build_model
    from repro_torch.parallel.mesh import make_test_mesh
    from repro_torch.parallel.sharding import (Concat, MeshAxes,
                                               layout_specs, map_with_path,
                                               param_specs)
    for arch in ("mamba2-2.7b:reduced", "recurrentgemma-9b:reduced",
                 "small-gpt"):
        cfg = resolve_config(arch)
        shapes = build_model(cfg).init(torch.Generator().manual_seed(0))
        for shape in ((1, 2), (2, 1), (2, 2)):
            mesh = make_test_mesh(shape, ("data", "model"))
            flat_b, flat_p = {}, {}
            for fn, flat in ((param_specs, flat_b), (layout_specs, flat_p)):
                map_with_path(lambda p, s: flat.__setitem__(p, s),
                              fn(cfg, shapes, mesh, MeshAxes()))
            changed = {p[-2:] for p in flat_b if flat_b[p] != flat_p[p]}
            if cfg.family != "ssm" or shape[1] == 1:
                assert not changed, (arch, shape)
                continue
            assert changed == {("ssm", "w_zx"), ("ssm", "w_bc"),
                               ("conv", "w")}, changed
            for p, spec in flat_p.items():
                if p[-1] == "w_bc":
                    assert spec[-1] is None
                elif p[-1] == "w_zx" or p[-2:] == ("conv", "w"):
                    assert isinstance(spec[-1], Concat)
