"""The MoE FFN on a mesh of the port (`models/moe.py`'s mesh paths, the
shared expert's tensor split, the dp-global aux terms): one module-scoped
spawn of 4 gloo ranks on the CPU, a (2, 2) ("data", "model") mesh, and
all JAX references from one subprocess with 4 forced host devices (as
`tests/test_multidevice.py` runs its mesh checks), started together.

Weights come from the port's init (seed 3, f32) and go to JAX as numpy
arrays, the batches from a numpy generator. Each rank runs, for
llama4-scout and kimi-k2 at `:reduced` (B=4, S=16, sgd lr 1e-2, the jit
engine):

  keep      2 steps on the (2, 2) mesh, every layer kept, the first
            step's gradients captured (this rank's shards);
  off       the same with the layers spooled (fs, `host_offload=
            "activations"`);
  ep        keep with `ep_axis="model"` at capacity factor E/k (every
            local row has its slot: the same computation as keep);
  adamw     llama4 only: keep with adamw (clip 1.0), the engine's own
            update (ZeRO-1 moments, the global norm over the mesh);

then `apply_moe` with `ep_axis="model"` and `dp_axes=("data",)` on
JAX's shapes (E=8, k=2, D=32, F=64; x (8, 16, 32)) at capacity factors
1.0 (rows dropped) and 8.0 (none), and one MoE block's forward under the
pack hook: which saved tensors are the same on every rank of the model
axis, and their 1/tp slices gathered back.

JAX computes the same 2 steps on one device (`api.loss`: CE plus the
aux terms, `jax.value_and_grad`, its `sgd`, and its `adamw` for llama4)
and its shard_map EP path on a (2, 2) mesh.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_one_thread import one_torch_thread  # noqa: E402,F401

ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
B, S, SEED, LR, STEPS = 4, 16, 3, 1e-2, 2
EP_D, EP_F, EP_E, EP_K = 32, 64, 8, 2
CAPS = (1.0, 8.0)
WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_test_mesh
from repro.models.api import build_model
from repro.models.moe import MoESettings, apply_moe
from repro.models.transformer import RunSettings
from repro.optim.optimizers import adamw, sgd
from repro.session.session import resolve_config

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
settings = RunSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")

compiled = {}

def steps(arch, opt):
    if arch not in compiled:
        cfg = dataclasses.replace(resolve_config(arch + ":reduced"),
                                  dtype="float32")
        api = build_model(cfg)
        compiled[arch] = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, settings), has_aux=True))
    step = compiled[arch]
    params = jax.tree.map(jnp.asarray, inp["weights"][arch])
    state = opt.init(params)
    rows, grads = [], None
    for batch in inp["batches"]:
        (loss, m), g = step(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        rows.append({k: float(m[k]) for k in ("loss", "ce", "moe_lb",
                                              "moe_z")})
        if grads is None:
            grads = jax.tree.map(np.asarray, g)
        params, state = opt.update(g, state, params)
    return {"rows": rows, "grads": grads}

for arch in inp["weights"]:
    out[arch] = steps(arch, sgd(inp["lr"]))
out[("adamw", inp["adamw_arch"])] = steps(inp["adamw_arch"],
                                          adamw(inp["lr"]))
mesh = make_test_mesh((2, 2), ("data", "model"))
ep = inp["ep"]
x = jnp.asarray(ep["x"])
moe_p = jax.tree.map(jnp.asarray, ep["params"])
x_sh = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
for cap in ep["caps"]:
    ms = MoESettings(ep["E"], ep["k"], capacity_factor=cap)
    with mesh:
        y, aux = jax.jit(lambda p, x: apply_moe(
            p, x, ms, mesh=mesh, ep_axis="model", dp_axes=("data",)))(
            moe_p, x_sh)
    out[("ep", cap)] = {"y": np.asarray(y),
                        "aux": {k: float(v) for k, v in aux.items()}}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy()


def _cfg(arch):
    from repro_torch.configs import resolve_config
    return dataclasses.replace(resolve_config(arch + ":reduced"),
                               dtype="float32")


def _inputs() -> dict:
    """Weights (the port's init), batches and the EP check's inputs."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import init_moe
    weights = {}
    for arch in ARCHS:
        gen = torch.Generator().manual_seed(SEED)
        weights[arch] = _numpy(build_model(_cfg(arch)).init(gen))
    rng = np.random.default_rng(SEED)
    vocab = _cfg(ARCHS[0]).vocab_size
    batches = [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
                "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
               for _ in range(STEPS)]
    gen = torch.Generator().manual_seed(1)
    ep = {"params": _numpy(init_moe(gen, EP_D, EP_F, EP_E, torch.float32)),
          "x": rng.standard_normal((8, 16, EP_D)).astype(np.float32),
          "E": EP_E, "k": EP_K, "caps": CAPS}
    return {"weights": weights, "batches": batches, "ep": ep, "lr": LR,
            "adamw_arch": ARCHS[0]}


def _rank_runs(rank: int, d: str, inp: dict) -> dict:
    from repro_torch.configs import SpoolIoConfig
    from repro_torch.core.meshrun import MeshRun, shard_tree
    from repro_torch.models.moe import MoESettings, apply_moe
    from repro_torch.models.transformer import (BlockDef, RunSettings,
                                                apply_block, layer)
    from repro_torch.optim.optimizers import adamw, sgd
    from repro_torch.parallel.comm import init_mesh, save_scope, \
        saved_replicated
    from repro_torch.parallel.sharding import MeshAxes, param_specs
    from repro_torch.session import TrainSession

    mesh = init_mesh((2, 2), ("data", "model"), device="cpu")
    axes = MeshAxes(dp=("data",), tp="model")
    out = {}

    def run(arch, label, *, policy="keep", io=None, ep_axis=None,
            cap=1.25, optimizer=None):
        settings = RunSettings(
            attn_impl="torch", attn_chunk=8, param_dtype="float32",
            device="cpu", activation_policy=policy, ep_axis=ep_axis,
            moe_capacity_factor=cap)
        grads = []

        def capture(g, opt_state, params):
            if not grads:
                grads.append(_numpy(g))
            return sess.optimizer.update(g, opt_state, params)

        with TrainSession(_cfg(arch), engine="jit", device="cpu", io=io,
                          settings=settings, optimizer=optimizer or sgd(LR),
                          batch_size=B, seq_len=S, seed=SEED,
                          min_offload_elements=0, mesh=mesh) as sess:
            sess.set_params(inp["weights"][arch])
            rows = []
            for batch in inp["batches"]:
                # adamw runs the engine's own update: ZeRO-1 moments and
                # the mesh's global norm for its clipping
                sess.params, sess.opt_state, rep = sess.engine.train_step(
                    sess.params, sess.opt_state, [batch],
                    update=None if optimizer else capture)
                rows.append({"loss": rep.loss, **{
                    k: rep.extra[k] for k in ("ce", "moe_lb", "moe_z")}})
            rec = {"rows": rows, "grads": grads[0] if grads else None}
        if io is not None:
            rec["left"] = sorted(os.listdir(io.directory))
        out[(arch, label)] = rec

    for arch in ARCHS:
        cfg = _cfg(arch)
        run(arch, "keep")
        run(arch, "off", policy="spool", io=SpoolIoConfig(
            backend="fs", directory=os.path.join(d, f"off_{arch}"),
            host_offload="activations"))
        run(arch, "ep", ep_axis="model",
            cap=cfg.moe_num_experts / cfg.moe_top_k)
        specs = param_specs(cfg, inp["weights"][arch], mesh, axes)
        out[(arch, "specs")] = specs
    run(inp["adamw_arch"], "adamw", optimizer=adamw(LR))

    # apply_moe with ep_axis on this rank's rows and experts
    ep = inp["ep"]
    rows = ep["x"].shape[0] // 2
    i, j = mesh.coords["data"], mesh.coords["model"]
    x = torch.from_numpy(ep["x"][i * rows:(i + 1) * rows])
    n = ep["E"] // 2
    p = {k: torch.from_numpy(v if k == "router" else v[j * n:(j + 1) * n])
         for k, v in ep["params"].items()}
    for cap in ep["caps"]:
        y, aux = apply_moe(p, x, MoESettings(ep["E"], ep["k"], cap),
                           mesh=mesh, ep_axis="model", dp_axes=("data",))
        out[("ep", cap)] = {"y": y.numpy(), "aux": {
            k: float(v) for k, v in aux.items()}}

    # one MoE block's saved tensors: replicated over the model axis or
    # this rank's own, and their slices gathered back
    cfg = _cfg(ARCHS[1])
    w = shard_tree(inp["weights"][ARCHS[1]],
                   param_specs(cfg, inp["weights"][ARCHS[1]], mesh, axes,
                               fsdp=False), mesh)
    blk = _tensors(layer(w["segments"][-1], 0)["b0"])
    settings = RunSettings(attn_impl="torch", attn_chunk=8,
                           param_dtype="float32", device="cpu", mesh=mesh,
                           tp_axis="model", dp_axes=("data",))
    x = torch.randn((B // 2, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    x = x.requires_grad_(True)
    saved, flags = [], []

    def pack(t):
        saved.append(t)
        flags.append(saved_replicated(t))
        return len(saved) - 1

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda i: saved[i]), \
            save_scope():
        y, _ = apply_block(BlockDef("attn", mlp="moe"), blk, x, cfg,
                           settings, positions=torch.arange(S), aux={})
    mr = MeshRun(settings)
    packed, cuts = mr.pack(saved, flags)
    back = mr.unpack(packed, cuts)
    out["saved"] = {
        "kinds": [(tuple(t.shape), str(t.dtype), f)
                  for t, f in zip(saved, flags)],
        "cut_of": [(tuple(saved[c[0]].shape), str(saved[c[0]].dtype))
                   for c in cuts],
        "bitwise": all(torch.equal(a, b) for a, b in zip(saved, back)),
        "n_experts_here": blk["moe"]["w_in"].shape[0],
        "T": x.shape[0] * S, "E": cfg.moe_num_experts,
        "k": cfg.moe_top_k, "D": cfg.d_model, "F": cfg.d_ff,
    }
    return out


def _tensors(tree):
    """Leaves that require grad, as the engine's stage parameters do."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).requires_grad_(True)


def _worker(rank, port, d, inp_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        out = _rank_runs(rank, d, inp)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    d = str(tmp_path_factory.mktemp("mesh_moe"))
    inp = _inputs()
    inp_path = os.path.join(d, "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_out = os.path.join(d, "jax.pkl")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, inp_path,
                             jax_out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        mp.start_processes(_worker, args=(_free_port(), d, inp_path),
                           nprocs=WORLD, start_method="spawn")
    finally:
        log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[r], f"rank {r}: {ranks[r]['error']}"
    with open(jax_out, "rb") as f:
        jax_ref = pickle.load(f)
    return {"ranks": ranks, "jax": jax_ref, "inputs": inp}


def _flat(tree):
    from repro_torch.core.tree import tree_flatten
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mesh_losses_and_aux_match_the_jax_single_device_loss(runs,
                                                                  arch):
    want = runs["jax"][arch]["rows"]
    for res in runs["ranks"]:
        for got, ref in zip(res[(arch, "keep")]["rows"], want):
            for k in ("loss", "ce", "moe_lb", "moe_z"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                           err_msg=k)


def test_adamw_on_the_mesh_matches_jax(runs):
    """adamw (clip 1.0) on the (2, 2) mesh: its moments sharded as the
    parameters (ZeRO-1, fsdp over "data" on the experts' D dim) and the
    clipping norm summed over the mesh; step 2's loss and aux terms
    follow from them, against JAX's on one device."""
    arch = runs["inputs"]["adamw_arch"]
    want = runs["jax"][("adamw", arch)]["rows"]
    for res in runs["ranks"]:
        for got, ref in zip(res[(arch, "adamw")]["rows"], want):
            for k in ("loss", "ce", "moe_lb", "moe_z"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                           err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mesh_gradients_match_jax_shard_for_shard(runs, arch):
    """The first step's gradients on each rank: JAX's (loss with aux)
    cut by the parameter specs at the rank's coordinates."""
    from repro_torch.core.meshrun import shard_tree
    from repro_torch.parallel.mesh import make_test_mesh
    want_tree = runs["jax"][arch]["grads"]
    for rank, res in enumerate(runs["ranks"]):
        mesh = make_test_mesh((2, 2), ("data", "model"), rank=rank)
        want = _flat(shard_tree(want_tree, res[(arch, "specs")], mesh))
        got = _flat(res[(arch, "keep")]["grads"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ["off", "ep"])
def test_spooled_and_full_capacity_ep_runs_equal_keep_bitwise(runs, arch,
                                                               run):
    """Spooling is transparent on a mesh; `ep_axis` at capacity E/k
    drops no row and runs keep's computation."""
    for res in runs["ranks"]:
        keep = res[(arch, "keep")]
        assert res[(arch, run)]["rows"] == keep["rows"]
        for a, b in zip(_flat(res[(arch, run)]["grads"]),
                        _flat(keep["grads"])):
            assert np.array_equal(a, b)
        if run == "off":
            assert res[(arch, run)]["left"] == []


def test_every_rank_reports_the_same_losses(runs):
    first = runs["ranks"][0]
    for res in runs["ranks"][1:]:
        for arch in ARCHS:
            assert res[(arch, "keep")]["rows"] == first[(arch, "keep")][
                "rows"]


@pytest.mark.parametrize("cap", CAPS)
def test_apply_moe_ep_matches_jax_shard_map(runs, cap):
    """`apply_moe(..., ep_axis="model", dp_axes=("data",))` on each rank's
    rows and experts against JAX's shard_map path (JAX's 2e-4 bar): the
    same drops at 1.0, none at 8.0."""
    want = runs["jax"][("ep", cap)]
    rows = runs["inputs"]["ep"]["x"].shape[0] // 2
    # the largest factor drops nothing (JAX's local path is its output)
    local = runs["jax"][("ep", max(CAPS))]["y"]
    for rank, res in enumerate(runs["ranks"]):
        i = rank // 2
        got = res[("ep", cap)]
        ref = want["y"][i * rows:(i + 1) * rows]
        np.testing.assert_allclose(got["y"], ref, rtol=2e-4, atol=2e-5)
        for k in ("moe_lb", "moe_z"):
            np.testing.assert_allclose(got["aux"][k], want["aux"][k],
                                       rtol=1e-5)
        dropped = np.abs(ref - local[i * rows:(i + 1) * rows]).max() > 1e-4
        assert dropped == (cap == 1.0)


def test_replicated_saved_tensors_are_stored_as_slices(runs):
    """One MoE block (kimi's, with the shared expert) under the pack hook
    on the model axis: the router's outputs, the expert ids and the
    block input are the same on every rank and cut to 1/tp slices; the
    dispatch buffer, the expert hidden states and the slot indices are
    this rank's and stored whole; every slice gathers back bit for bit
    (int64 ids included)."""
    for res in runs["ranks"]:
        sv = res["saved"]
        T, E, k, D = sv["T"], sv["E"], sv["k"], sv["D"]
        el = sv["n_experts_here"]
        assert el == E // 2
        kinds = sv["kinds"]
        rep = {(s, dt) for s, dt, f in kinds if f}
        own = {(s, dt) for s, dt, f in kinds if not f}
        assert ((T, E), "torch.float32") in rep          # router logits
        assert ((T, k), "torch.int64") in rep            # expert ids
        assert ((T, D), "torch.float32") in rep          # block input
        assert ((el, T, D), "torch.float32") in own      # dispatch
        assert ((el, T, sv["F"]), "torch.float32") in own   # hidden
        assert ((T * k,), "torch.int64") in own          # slots
        assert not any(s[:2] == (el, T) for s, _ in rep)
        assert ((T, k), "torch.int64") in sv["cut_of"]
        assert sv["bitwise"]
