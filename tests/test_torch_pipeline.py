"""The GPipe pipeline (`parallel/pipeline.py`) and the int8
error-feedback dp mean (`parallel/compress.py`) of the port: one
module-scoped spawn of 4 gloo ranks on the CPU, and the JAX references
from one subprocess with 4 forced host devices (the checks of
`tests/test_multidevice.py:84-138`), started together.

Each rank runs, on a ("pipe",) mesh of 4:
  * `pipeline_apply` and the gradients of `pipeline_loss_fn` for JAX's
    stage (tanh(x @ w), 4 stages, M=8 microbatches of (2, 16)), the loss
    head sum(y * aux) with a random aux;
  * the same for the port's transformer block (a small GPT block, f32,
    plain attention; its 4 layers one a stage, M=3 microbatches of
    (2, 8, 128));
and, on a ("data",) mesh of 4:
  * `compressed_mean_grads` / `exact_mean_grads` of JAX's identical
    per-rank gradients (a (8, 64) leaf), and of distinct per-rank
    gradients (two leaves);
  * 16 error-feedback rounds of the identical gradients.

The tests hold them against JAX's `pipeline_apply` / `jax.grad` of its
`pipeline_loss_fn` and its `compressed_mean_grads` (1e-5 outputs, 1e-4
gradients), the sequential loop on one device, and a numpy form of the
quantizer for the distinct gradients.
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

WORLD = 4
N_STAGE, M, MB, DP = 4, 8, 2, 16
BLK_M, BLK_B, BLK_S = 3, 2, 8
ROUNDS = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.parallel.compress import (compressed_mean_grads,
                                     exact_mean_grads, init_error_state)
from repro.parallel.pipeline import pipeline_apply, pipeline_loss_fn

inp = pickle.load(open(sys.argv[1], "rb"))
ws, x, aux = (jnp.asarray(inp[k]) for k in ("ws", "x", "aux"))
pmesh = make_test_mesh((4,), ("pipe",))

def stage_fn(w, x):
    return jnp.tanh(x @ w)

with pmesh:
    y = pipeline_apply(stage_fn, ws, x, pmesh)
    g = jax.jit(jax.grad(pipeline_loss_fn(
        stage_fn, lambda y, a: jnp.sum(y * a), pmesh)))(ws, x, aux)
gmesh = make_test_mesh((4,), ("data",))
grads = {"w": jnp.asarray(inp["same"])}
# one compiled round (eager, each call traces its shard_map anew)
mean = jax.jit(lambda g, e: compressed_mean_grads(g, e, gmesh, "data"))
with gmesh:
    exact = exact_mean_grads(grads, gmesh, "data")
    comp, err = mean(grads, init_error_state(grads))
    e = init_error_state(grads)
    acc = jnp.zeros_like(exact["w"])
    for _ in range(inp["rounds"]):
        c, e = mean(grads, e)
        acc = acc + c["w"] / inp["rounds"]
pickle.dump({"y": np.asarray(y), "g": np.asarray(g),
             "exact": np.asarray(exact["w"]), "comp": np.asarray(comp["w"]),
             "err": np.asarray(err["w"]), "acc": np.asarray(acc)},
            open(sys.argv[2], "wb"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _block_cfg():
    from repro_torch.configs.paper_models import small_gpt
    return dataclasses.replace(small_gpt(128, N_STAGE), dtype="float32")


def _block_fn():
    from repro_torch.models.transformer import (BlockDef, RunSettings,
                                                apply_block)
    cfg = _block_cfg()
    settings = RunSettings(attn_impl="torch", attn_chunk=BLK_S,
                           param_dtype="float32", device="cpu")
    pos = torch.arange(BLK_S) if cfg.use_rope else None

    def stage_fn(p, x):
        return apply_block(BlockDef("attn"), p, x, cfg, settings,
                           positions=pos)[0]
    return stage_fn


def _block_inputs():
    """A small GPT's stacked layers (the port's init) and its inputs."""
    from repro_torch.models.api import build_model
    cfg = _block_cfg()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    blk = params["segments"][0]["b0"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((BLK_M, BLK_B, BLK_S, cfg.d_model), generator=gen)
    aux = torch.randn(x.shape, generator=gen)
    return blk, x, aux


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "ws": (rng.normal(size=(N_STAGE, DP, DP)) * 0.3).astype(np.float32),
        "x": rng.normal(size=(M, MB, DP)).astype(np.float32),
        "aux": rng.normal(size=(M, MB, DP)).astype(np.float32),
        "same": rng.normal(size=(8, 64)).astype(np.float32),
        "distinct": [{"a": rng.normal(size=(8, 64)).astype(np.float32)
                      * (r + 1),
                      "b": rng.normal(size=(3, 5, 7)).astype(np.float32)}
                     for r in range(WORLD)],
        "rounds": ROUNDS,
    }


def _rank_runs(rank: int, inp: dict) -> dict:
    from repro_torch.core.tree import tree_flatten
    from repro_torch.parallel import (compressed_mean_grads,
                                      exact_mean_grads, init_error_state,
                                      pipeline_apply, pipeline_loss_fn)
    from repro_torch.parallel.comm import init_mesh

    out = {}
    pmesh = init_mesh((WORLD,), ("pipe",), device="cpu")

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    ws = torch.from_numpy(inp["ws"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    aux = torch.from_numpy(inp["aux"])
    out["y"] = pipeline_apply(stage_fn, ws, x, pmesh).detach().numpy()
    loss = pipeline_loss_fn(stage_fn, lambda y, a: (y * a).sum(),
                            pmesh)(ws, x, aux)
    loss.backward()
    out["g"], out["gx"] = ws.grad.numpy(), x.grad.numpy()

    # the port's transformer block, one layer a stage
    blk, bx, baux = _block_inputs()
    stacked = {k: v.detach().clone().requires_grad_(True)
               for k, v in _flat_dict(blk).items()}
    by = pipeline_apply(_block_fn(), _nest(stacked), bx, pmesh)
    (by * baux).sum().backward()
    out["blk_y"] = by.detach().numpy()
    out["blk_g"] = {k: v.grad[rank].numpy() for k, v in stacked.items()}

    gmesh = init_mesh((WORLD,), ("data",), device="cpu")
    same = {"w": torch.from_numpy(inp["same"])}
    comp, err = compressed_mean_grads(same, init_error_state(same), gmesh,
                                      "data")
    out["comp"], out["err"] = comp["w"].numpy(), err["w"].numpy()
    out["exact"] = exact_mean_grads(same, gmesh, "data")["w"].numpy()
    e = init_error_state(same)
    acc = torch.zeros_like(same["w"])
    for _ in range(inp["rounds"]):
        c, e = compressed_mean_grads(same, e, gmesh, "data")
        acc = acc + c["w"] / inp["rounds"]
    out["acc"] = acc.numpy()
    mine = {k: torch.from_numpy(v) for k, v in inp["distinct"][rank].items()}
    comp, err = compressed_mean_grads(mine, init_error_state(mine), gmesh,
                                      "data")
    out["d_comp"] = {k: v.numpy() for k, v in comp.items()}
    out["d_err"] = {k: v.numpy() for k, v in err.items()}
    out["d_exact"] = {k: v.numpy() for k, v in exact_mean_grads(
        mine, gmesh, "data").items()}
    assert len(tree_flatten(comp)[0]) == 2
    return out


def _flat_dict(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_dict(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _worker(rank, port, d, inp_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        out = _rank_runs(rank, inp)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    d = str(tmp_path_factory.mktemp("pipeline"))
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


def _sequential(inp):
    """The stages applied in order on one device, and the gradients of
    the loss head."""
    ws = torch.from_numpy(inp["ws"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = x
    for s in range(N_STAGE):
        y = torch.tanh(y @ ws[s])
    (y * torch.from_numpy(inp["aux"])).sum().backward()
    return y.detach().numpy(), ws.grad.numpy(), x.grad.numpy()


def test_pipeline_outputs_match_jax_and_the_sequential_loop(runs):
    want, _, _ = _sequential(runs["inputs"])
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["y"], runs["jax"]["y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["y"], want, rtol=1e-5, atol=1e-5)


def test_each_stage_ends_with_jax_g_pipe_of_its_stage(runs):
    """Rank s holds the gradient of its stage's slice (JAX's g_pipe[s])
    and zeros in the other stages' slices."""
    _, want, _ = _sequential(runs["inputs"])
    for s, res in enumerate(runs["ranks"]):
        np.testing.assert_allclose(res["g"][s], runs["jax"]["g"][s],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["g"][s], want[s], rtol=1e-4,
                                   atol=1e-5)
        others = [t for t in range(N_STAGE) if t != s]
        assert not res["g"][others].any()


def test_the_input_gradient_reaches_every_rank(runs):
    _, _, want = _sequential(runs["inputs"])
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["gx"], want, rtol=1e-4, atol=1e-5)
        assert np.array_equal(res["gx"], runs["ranks"][0]["gx"])


def test_transformer_blocks_through_the_pipeline_match_one_device(runs):
    """The port's attention + MLP block, one layer a stage: outputs at
    1e-5 and each stage's parameter gradients at 1e-4 of the layers run
    in sequence on one device, microbatch by microbatch."""
    from repro_torch.models.transformer import layer
    blk, x, aux = _block_inputs()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _flat_dict(blk).items()}
    tree, fn = _nest(leaves), _block_fn()
    ys = []
    for m in range(BLK_M):
        y = x[m]
        for s in range(N_STAGE):
            y = fn(layer(tree, s), y)
        ys.append(y)
    y = torch.stack(ys)
    (y * aux).sum().backward()
    for s, res in enumerate(runs["ranks"]):
        np.testing.assert_allclose(res["blk_y"], y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        for k, g in res["blk_g"].items():
            want = leaves[k].grad[s].numpy()
            np.testing.assert_allclose(g, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def test_compressed_mean_matches_jax_for_identical_grads(runs):
    j = runs["jax"]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["exact"], j["exact"], rtol=1e-6)
        scale = np.abs(j["err"]).max() * 2
        np.testing.assert_allclose(res["comp"], j["comp"], atol=scale)
        np.testing.assert_allclose(res["err"], j["err"], atol=scale)
        rel = np.abs(res["comp"] - res["exact"]).max() / np.abs(
            res["exact"]).max()
        assert rel < 0.05


def _numpy_quantize(e):
    scale = np.float32(max(np.abs(e).max() / np.float32(127.0), 1e-20))
    q = np.clip(np.round(e / scale), -127, 127).astype(np.int8)
    return q, scale


def test_compressed_mean_matches_the_formula_for_distinct_grads(runs):
    """Distinct per-rank gradients: the mean of the ranks' dequantized
    int8 (in rank order) and each rank's residual, from a numpy form of
    the quantizer (round half to even, clip to +-127)."""
    dist = runs["inputs"]["distinct"]
    for k in ("a", "b"):
        qs = [_numpy_quantize(r[k]) for r in dist]
        total = np.zeros_like(dist[0][k])
        for q, s in qs:
            total = total + q.astype(np.float32) * s
        want = total / np.float32(WORLD)
        for rank, res in enumerate(runs["ranks"]):
            np.testing.assert_allclose(res["d_comp"][k], want, rtol=1e-6,
                                       atol=1e-7)
            q, s = qs[rank]
            np.testing.assert_allclose(
                res["d_err"][k], dist[rank][k] - q.astype(np.float32) * s,
                rtol=1e-6, atol=1e-7)
            exact = res["d_exact"][k]
            rel = np.abs(res["d_comp"][k] - exact).max() / np.abs(
                exact).max()
            assert rel < 0.05, rel


def test_error_feedback_shrinks_the_accumulated_error(runs):
    """16 rounds of the same gradients: the mean of the compressed
    estimates is nearer the exact mean than one round's (JAX's check),
    and near JAX's own accumulation."""
    for res in runs["ranks"]:
        exact = np.abs(res["exact"]).max()
        rel = np.abs(res["comp"] - res["exact"]).max() / exact
        rel_acc = np.abs(res["acc"] - res["exact"]).max() / exact
        assert rel_acc < rel, (rel_acc, rel)
        np.testing.assert_allclose(res["acc"], runs["jax"]["acc"],
                                   atol=rel * exact)
