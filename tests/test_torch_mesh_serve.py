"""Serving on a mesh (`launch/steps.py::make_prefill_step` /
`make_decode_step`): one module-scoped spawn of 2 gloo ranks on the CPU.

Every family at a small size in f32: small-gpt, qwen2.5-3b:reduced (GQA
with qkv biases), gemma2-27b:reduced (a window ring, softcaps,
post-norms), mamba2-2.7b:reduced, recurrentgemma-9b reduced to 3 layers
(one period: its single kv head is held whole on every rank),
llama4-scout:reduced (MoE through `ep_axis`) and
llama-3.2-vision-90b:reduced (cross decode), and `small_t5()`. Each is
served on a (1, 2) ("data", "model") mesh (tp=2, TP-only weights) and
on a (2, 1) mesh (dp=2), where the workers set
`steps.SERVE_TP_ONLY_BUDGET` below every model so the weights are fsdp
(each layer gathered just before it runs). A prefill of `P` of `S`
cache positions, then `DECODE` teacher-forced decode steps.

The weights are the port's init from `SEED` (the builders'), handed to
JAX as numpy arrays. Each rank's logits (its rows, whole over the
vocab) are held within 1e-4 of JAX's single-device `prefill` /
`decode_step` (relative to the largest magnitude) and within 1e-5 of
the port's one device; the caches each rank emits, gathered by
`parallel/sharding.py::cache_layout_specs`, within 1e-5 of one device's
cache, and their shapes equal the decode builder's own cache. The MoE
runs hold the capacity at E/k (dropless, the function JAX's one device
computes); a second llama4 run at capacity 1.25 records every
`apply_moe` call, and the rows it drops equal those JAX's
`_route` / `_expert_ranks` drop at the same rows and capacity. A tensor
axis that does not divide the query heads, the SSM heads or the RG-LRU
width is refused with a ValueError naming them.
"""
import dataclasses
import math
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_one_thread import one_torch_thread  # noqa: E402,F401

SEED, B, S, P, DECODE = 5, 2, 32, 28, 4
WORLD = 2
ARCHS = ("small-gpt", "qwen2.5-3b:reduced", "gemma2-27b:reduced",
         "mamba2-2.7b:reduced", "recurrentgemma-9b:3",
         "llama4-scout-17b-a16e:reduced", "llama-3.2-vision-90b:reduced",
         "small-t5")
MOE = "llama4-scout-17b-a16e:reduced"
MESHES = {"tp": (1, 2), "dp": (2, 1)}
TOL_JAX, TOL_PORT = 1e-4, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg(arch):
    from repro_torch.configs import get_config, reduced, resolve_config
    from repro_torch.configs import small_t5
    if arch == "small-t5":
        cfg = small_t5()
    elif arch == "recurrentgemma-9b:3":
        cfg = reduced(get_config("recurrentgemma-9b"), layers=3)
    else:
        cfg = resolve_config(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _jcfg(arch):
    from repro.configs import paper_models as jpm
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_config as jget
    from repro.session.session import resolve_config as jresolve
    if arch == "small-t5":
        cfg = jpm.small_t5()
    elif arch == "recurrentgemma-9b:3":
        cfg = jreduced(jget("recurrentgemma-9b"), layers=3)
    else:
        cfg = jresolve(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _settings(cfg, mesh, kind, capacity=None):
    """The builders' settings with the plain attention, the MoE capacity
    at E/k (dropless) unless `capacity` is given."""
    from repro_torch.launch.steps import build_settings
    from repro_torch.parallel.sharding import MeshAxes
    s = build_settings(cfg, mesh, MeshAxes(), kind=kind, attn_impl="torch",
                       device="cpu")
    if cfg.moe_num_experts:
        s = dataclasses.replace(s, moe_capacity_factor=capacity or (
            cfg.moe_num_experts / cfg.moe_top_k))
    return s


def _shapes():
    from repro_torch.configs.base import ShapeConfig
    return (ShapeConfig("p", S, B, "prefill"),
            ShapeConfig("d", S, B, "decode"))


def _prompt(batch):
    return {k: v[:, :P] if k == "tokens" else v for k, v in batch.items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().float().numpy().copy()


def _map(fn, *trees):
    """fn over the leaves of same-structure trees of dicts and lists (a
    tuple, a shape, is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _serve(arch, mesh, tokens, cache_shapes, capacity=None):
    """Prefill and DECODE teacher-forced steps of `arch` through the
    builders (one device when `mesh` is None): the logits, the caches
    (gathered over the mesh) and the decode builder's cache shapes."""
    from repro_torch.core.meshrun import gather_leaf, wrap_specs
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import MeshAxes, cache_layout_specs
    cfg = _cfg(arch)
    api = build_model(cfg)
    pshape, dshape = _shapes()
    pb = steps.make_prefill_step(api, mesh, MeshAxes(), pshape,
                                 settings=_settings(cfg, mesh, "prefill",
                                                    capacity),
                                 device="cpu", seed=SEED)
    params, batch = pb.args
    logits, caches = pb.fn(params, _prompt(batch))
    rec = {"fsdp": pb.fsdp, "prefill": _numpy(logits),
           "cache_shapes": _map(lambda t: tuple(t.shape), caches)}
    if mesh is not None:
        specs = cache_layout_specs(_map(
            lambda shp: torch.empty(shp, device="meta"), cache_shapes),
            mesh, MeshAxes())
        rec["cache"] = _numpy(_map(lambda t, sp: gather_leaf(t, sp, mesh),
                                   caches, wrap_specs(specs)))
    else:
        rec["cache"] = _numpy(caches)
    db = steps.make_decode_step(api, mesh, MeshAxes(), dshape,
                                settings=_settings(cfg, mesh, "decode",
                                                   capacity),
                                device="cpu", seed=SEED)
    rec["decode_cache_shapes"] = _map(lambda t: tuple(t.shape),
                                      db.args[1])
    rows = steps.rank_rows(B, mesh, MeshAxes())
    lo = mesh.coords["data"] * rows if mesh is not None and rows < B else 0
    rec["decode"] = []
    for i, tok in enumerate(tokens):
        out = db.fn(db.args[0], caches,
                    {"tokens": torch.from_numpy(tok[lo:lo + rows])},
                    torch.tensor(P + i, dtype=torch.int32))
        rec["decode"].append(_numpy(out))
    rec["rows"] = (lo, lo + rows)
    return rec


def _ep_calls(mesh, tokens, cache_shapes):
    """llama4 at capacity 1.25 through `ep_axis`: every `apply_moe` call
    of its prefill and decode steps with the rows it saw, the router,
    its experts and the rows `moe.dropped_rows` counted."""
    from repro_torch.models import moe, transformer
    calls = []
    real = transformer.apply_moe

    def recorded(params, x, settings, **kw):
        before = moe.dropped_rows.read()
        out = real(params, x, settings, **kw)
        here = params["w_in"].shape[0]
        grp = kw["mesh"].coords.get(kw["tp_axis"], 0)
        calls.append({"x": x.detach().numpy().copy(),
                      "router": params["router"].detach().numpy().copy(),
                      "e0": grp * here if here != settings.num_experts
                      else 0, "local": here,
                      "cf": settings.capacity_factor,
                      "dropped": moe.dropped_rows.read() - before})
        return out

    transformer.apply_moe = recorded
    try:
        _serve(MOE, mesh, tokens, cache_shapes, capacity=1.25)
    finally:
        transformer.apply_moe = real
    return calls


def _rank_runs(inputs) -> dict:
    from repro_torch.launch import steps
    from repro_torch.parallel.comm import init_mesh
    out = {}
    for mname, shape in MESHES.items():
        mesh = init_mesh(shape, ("data", "model"), device="cpu")
        budget = steps.SERVE_TP_ONLY_BUDGET
        if mname == "dp":
            steps.SERVE_TP_ONLY_BUDGET = -1          # fsdp for every model
        try:
            for arch in ARCHS:
                out[(mname, arch)] = _serve(arch, mesh,
                                            inputs[arch]["tokens"],
                                            inputs[arch]["cache_shapes"])
            out[(mname, "ep")] = _ep_calls(mesh, inputs[MOE]["tokens"],
                                           inputs[MOE]["cache_shapes"])
        finally:
            steps.SERVE_TP_ONLY_BUDGET = budget
    return out


def _worker(rank, port, d, inputs_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        out = _rank_runs(inputs)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_serve(arch, params, batch, tokens):
    """JAX's single-device prefill and decode steps on the port's
    weights: (prefill logits, [decode logits])."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jbuild
    from repro.models.transformer import RunSettings as JSettings
    api = jbuild(_jcfg(arch))
    js = JSettings(attn_impl="xla", attn_chunk=1024, param_dtype="float32")
    jb = {k: jnp.asarray(v.float().numpy() if v.is_floating_point()
                         else v.numpy()) for k, v in _prompt(batch).items()}
    logits, cache = jax.jit(lambda p, b: api.prefill(
        p, b, js, cache_len=S))(params, jb)
    dec = jax.jit(lambda p, c, b, pos: api.decode_step(p, c, b, pos, js))
    out = []
    for i, tok in enumerate(tokens):
        lg, cache = dec(params, cache, {"tokens": jnp.asarray(tok)},
                        jnp.asarray(P + i, jnp.int32))
        out.append(np.asarray(lg))
    return np.asarray(logits), out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    d = str(tmp_path_factory.mktemp("mesh_serve"))
    rng = np.random.default_rng(SEED)
    inputs, ref, jax_ref = {}, {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tokens = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
                  for _ in range(DECODE)]
        ref[arch] = _serve(arch, None, tokens, None)
        inputs[arch] = {"tokens": tokens,
                        "cache_shapes": ref[arch]["cache_shapes"]}
    path = os.path.join(d, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_worker, args=(_free_port(), d, path),
                             nprocs=WORLD, start_method="spawn", join=False)
    try:
        # JAX's references while the ranks run
        for arch in ARCHS:
            api = build_model(_cfg(arch))
            params = _numpy(steps.global_params(api, "cpu", SEED))
            batch = steps._inputs(api, _shapes()[0], "cpu", SEED,
                                  for_loss=False)["batch"]
            jax_ref[arch] = _jax_serve(arch, params, batch,
                                       inputs[arch]["tokens"])
    finally:
        while not ctx.join():
            pass
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    return {"ranks": ranks, "port": ref, "jax": jax_ref}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _steps(rec):
    return [rec["prefill"]] + rec["decode"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_jax_single_device_steps(runs, arch, mesh):
    """Prefill's last logits and every decode step's, each rank's rows,
    within 1e-4 of JAX's one device over the largest magnitude."""
    jp, jd = runs["jax"][arch]
    vocab = _cfg(arch).vocab_size
    for res in runs["ranks"]:
        rec = res[(mesh, arch)]
        lo, hi = rec["rows"]
        for got, want in zip(_steps(rec), [jp] + jd):
            assert got.shape == (hi - lo, 1, want.shape[-1])
            assert _rel(got[..., :vocab], want[lo:hi, ..., :vocab]) \
                <= TOL_JAX


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_ports_one_device(runs, arch, mesh):
    one = runs["port"][arch]
    vocab = _cfg(arch).vocab_size
    for res in runs["ranks"]:
        rec = res[(mesh, arch)]
        lo, hi = rec["rows"]
        for got, want in zip(_steps(rec), _steps(one)):
            assert _rel(got[..., :vocab], want[lo:hi, ..., :vocab]) \
                <= TOL_PORT


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_caches_equal_one_devices(runs, arch, mesh):
    """Each rank's prefill caches (its rows; its kv heads, RG-LRU width
    or SSM heads), gathered by `cache_layout_specs`: K/V, conv windows
    and f32 states within 1e-5 of the one-device cache."""
    from repro_torch.core.tree import tree_flatten
    want = tree_flatten(runs["port"][arch]["cache"])[0]
    for res in runs["ranks"]:
        got = tree_flatten(res[(mesh, arch)]["cache"])[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= TOL_PORT * scale


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "small-t5"])
def test_prefill_caches_have_the_decode_builders_shapes(runs, arch, mesh):
    """What a rank's prefill emits is what `make_decode_step` takes (T5
    is left out: its `init_cache`, as JAX's, lays out the encoder's
    segments)."""
    for res in runs["ranks"]:
        rec = res[(mesh, arch)]
        assert rec["cache_shapes"] == rec["decode_cache_shapes"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_follows_the_budget(runs, mesh):
    for res in runs["ranks"]:
        for arch in ARCHS:
            assert res[(mesh, arch)]["fsdp"] == (mesh == "dp")


def test_whole_kv_heads_are_held_on_every_rank(runs):
    """recurrentgemma's one kv head does not split over tp=2: each rank's
    attention cache holds it whole; the RG-LRU caches hold half the
    width, and the gemma2 caches half the kv heads."""
    rec = runs["ranks"][0][("tp", "recurrentgemma-9b:3")]["cache_shapes"]
    one = runs["port"]["recurrentgemma-9b:3"]["cache_shapes"]
    assert rec[0]["b2"]["k"] == one[0]["b2"]["k"]
    assert rec[0]["b0"]["h"][-1] * 2 == one[0]["b0"]["h"][-1]
    g = runs["ranks"][0][("tp", "gemma2-27b:reduced")]["cache_shapes"]
    assert g[0]["b0"]["k"][3] * 2 == \
        runs["port"]["gemma2-27b:reduced"]["cache_shapes"][0]["b0"]["k"][3]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ep_drops_the_rows_jax_drops(runs, mesh):
    """Every `apply_moe` call of llama4's prefill and decode steps at
    capacity 1.25 through `ep_axis`: the rows dropped equal those JAX's
    routing drops at the same rows, experts and GShard capacity."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro_torch.models.transformer import build_segments
    cfg = _cfg(MOE)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    blocks = sum(seg.n_repeat for seg in build_segments(cfg)
                 for b in seg.blocks if b.mlp == "moe")
    dropped = 0
    for res in runs["ranks"]:
        calls = res[(mesh, "ep")]
        assert len(calls) == (1 + DECODE) * blocks
        for c in calls:
            x = c["x"].reshape(-1, cfg.d_model)
            eids, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(c["router"]),
                                     jmoe.MoESettings(E, k, c["cf"]))
            ef = jnp.reshape(eids, (-1,))
            rank = np.asarray(jmoe._expert_ranks(ef, E))
            ef = np.asarray(ef)
            cap = int(math.ceil(x.shape[0] * k / E * c["cf"]))
            local = (ef >= c["e0"]) & (ef < c["e0"] + c["local"])
            want = int((local & (rank >= cap)).sum())
            assert c["dropped"] == want
            dropped += want
    assert dropped > 0


@pytest.mark.parametrize("arch,words", [
    ("small-gpt", "query heads"), ("mamba2-2.7b:reduced", "SSM heads"),
    ("recurrentgemma-9b:reduced", "RG-LRU width")])
def test_a_tensor_axis_that_does_not_divide_is_refused(arch, words):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh, mesh_axes
    from repro_torch.models.api import build_model
    mesh = make_test_mesh((1, 3), dry=True)
    api = build_model(_cfg(arch))
    for make in (steps.make_prefill_step, steps.make_decode_step):
        kind = "prefill" if make is steps.make_prefill_step else "decode"
        with pytest.raises(ValueError, match=words):
            make(api, mesh, mesh_axes(mesh), ShapeConfig("s", S, B, kind),
                 attn_impl="torch", device="meta")
