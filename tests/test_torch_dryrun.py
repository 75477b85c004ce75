"""The port's dry run and step builders (`repro_torch.launch.{mesh,steps,
dryrun}`), on the CPU, against the JAX package's:

  * `count_params`, `active_param_count` and `param_bytes` equal JAX's
    (over `jax.eval_shape`) for every registry id;
  * `ModelApi.input_specs` and `init_cache` have JAX's shapes and dtypes
    for every arch x `SHAPES` cell that `cell_skip_reason` allows;
  * `model_flops`, `_predict_overlap` and `_predict_residency` equal
    JAX's on the same inputs, and `NOMINAL_WRITE_BW` is JAX's;
  * the dry-run count on the meta device equals the same step run for
    real on the CPU (small-gpt, `attn_impl="torch"`), exactly, in FLOPs,
    HBM bytes and host bytes; the prefill and decode builders too;
  * the FLOPs of small-gpt, small-bert and qwen2.5-3b:reduced (policy
    keep, `ce_chunk=0`) against JAX's `analyze_hlo(...).flops` of the
    compiled one-device step: within 1%. No product is counted
    differently by the two (the products and their count are equal), so
    the test holds the dot counts equal too;
  * a serving rank of a 1x2 and a 2x1 gloo CPU mesh: its meta trace
    over a `DryComm` equals its CPU step in FLOPs, HBM bytes, products,
    kernel calls and collectives;
  * one production cell's `run_cell` on the meta device: status ok, the
    JAX record's keys, within 30 s; serving cells on the production
    mesh: status ok; the cells `cell_skip_reason` skips and a cell whose
    mesh the port refuses are skipped with their reasons.
"""
import os
import time

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 resolve_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import cell_skip_reason
from repro_torch.launch import steps
from repro_torch.launch.op_stats import OpCounter
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import sgd
from repro_torch.parallel.sharding import map_with_path

jax = pytest.importorskip("jax")


def _jax_dryrun():
    """The JAX dry-run module, without the host-platform device count its
    import sets for its own process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


# ------------------------------------------------------------- counts

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    from repro.configs.registry import get_config as jget
    from repro.launch import steps as jsteps
    from repro.models.api import build_model as jbuild
    sds = jsteps._params_sds(jbuild(jget(arch)))
    cfg = get_config(arch)
    params = steps.global_params(build_model(cfg), "meta", 0)
    assert steps.count_params(params) == jsteps.count_params(sds)
    assert steps.count_params(params, exclude=()) == \
        jsteps.count_params(sds, exclude=())
    assert steps.active_param_count(cfg, params) == \
        jsteps.active_param_count(jget(arch), sds)
    assert steps.param_bytes(params) == jsteps.param_bytes(sds)


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree):
    out = {}
    map_with_path(lambda path, t: out.__setitem__(
        path, (tuple(t.shape), str(t.dtype).split(".")[-1])), tree)
    return out


CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if cell_skip_reason(get_config(a), SHAPES[s]) is None]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_cache_match_jax(arch, shape):
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import get_shape as jshape
    from repro.models.api import build_model as jbuild
    want = jbuild(jget(arch)).input_specs(jshape(shape))
    api = build_model(get_config(arch))
    got = api.input_specs(SHAPES[shape])
    assert sorted(got) == sorted(want)
    for part in want:
        if part == "pos":
            assert tuple(got["pos"].shape) == ()
            assert got["pos"].dtype == torch.int32
            continue
        assert _port_leaves(got[part]) == _jax_leaves(want[part]), part
    assert all(t.device.type == "meta" for t in
               _iter_tensors(got))
    if "cache" in want:
        sh = SHAPES[shape]
        assert _port_leaves(api.init_cache(sh.global_batch, sh.seq_len)) \
            == _jax_leaves(want["cache"])


def _iter_tensors(tree):
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def test_model_flops_overlap_and_residency_match_jax():
    from repro_torch.launch import dryrun
    jd = _jax_dryrun()
    for kind in ("train", "prefill", "decode"):
        assert dryrun.model_flops(kind, 7, 5, 1024) == \
            jd.model_flops(kind, 7, 5, 1024)
    for host, bw, t, opt in ((9.6e9, 2e9, 0.14, 0.0),
                             (1e8, 8e9, 3.0, 4e9), (0.0, 2e9, 1.0, 0.0)):
        assert dryrun._predict_overlap(host, bw, t, opt_bytes=opt) == \
            jd._predict_overlap(host, bw, t, opt_bytes=opt)
    for kind, opt in (("train", "adamw"), ("train", "sgd"),
                      ("decode", None)):
        assert dryrun._predict_residency(kind, 9.6e9, 3086200832, 256, opt,
                                         256 << 20) == \
            jd._predict_residency(kind, 9.6e9, 3086200832, 256, opt,
                                  256 << 20)
    assert dryrun.SGD_PARAM_THRESHOLD == jd.SGD_PARAM_THRESHOLD


def test_nominal_write_rates_are_the_jax_packages():
    import repro.cache.manager  # noqa: F401  (adds "managed")
    from repro.io.backend import NOMINAL_WRITE_BW as want
    import repro_torch.cache.manager  # noqa: F401
    from repro_torch.io.backend import NOMINAL_WRITE_BW as got
    assert got == want


def test_production_mesh_is_the_jax_one_seen_from_a_rank():
    from repro.launch.mesh import mesh_axes as jaxes
    from repro_torch.launch import mesh as pm
    single, multi = pm.make_production_mesh(), \
        pm.make_production_mesh(multi_pod=True, rank=300)
    assert single.devices_shape == (16, 16)
    assert single.axis_names == ("data", "model")
    assert multi.devices_shape == (2, 16, 16) and multi.rank == 300
    assert multi.comm.backend == "dry"
    for m in (single, multi):
        want = jaxes(m)
        assert pm.mesh_axes(m).dp == want.dp and pm.mesh_axes(m).tp == \
            want.tp
    assert (pm.PEAK_FLOPS_BF16, pm.PEAK_FLOPS_F32, pm.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert pm.link_bw(8) == pm.NVLINK_BW
    assert pm.link_bw(16) == pm.NODE_NET_BW_PER_CARD


# ------------------------------------------------- meta against the CPU

def _count(bundle, device):
    with OpCounter(device) as c:
        c.track(bundle.args)
        bundle.fn(*bundle.args)
    bundle.close()
    return c.analysis()


@pytest.mark.parametrize("policy", ["offload", "keep", "remat", "spool"])
def test_meta_count_equals_a_cpu_step(policy):
    api = build_model(resolve_config("small-gpt"))
    shape = ShapeConfig("t", 64, 2, "train")
    got = {}
    for dev in ("meta", "cpu"):
        got[dev] = _count(steps.make_train_step(
            api, None, None, sgd(), shape, activation_policy=policy,
            attn_impl="torch", device=dev), dev)
    meta, cpu = got["meta"], got["cpu"]
    assert meta.flops == cpu.flops > 0
    assert meta.hbm_bytes == cpu.hbm_bytes > 0
    assert meta.host_bytes == cpu.host_bytes
    assert meta.dot_count == cpu.dot_count
    if policy in ("offload", "spool"):
        assert meta.host_bytes > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_builders_count_the_same_on_meta_and_the_cpu(kind):
    api = build_model(resolve_config("small-gpt"))
    shape = ShapeConfig("s", 64, 2, kind)
    got = {dev: _count(steps.make_step(api, None, None, shape,
                                       attn_impl="torch", device=dev), dev)
           for dev in ("meta", "cpu")}
    assert got["meta"].flops == got["cpu"].flops > 0
    assert got["meta"].hbm_bytes == got["cpu"].hbm_bytes


# ----------------------------------- a serving rank, meta against gloo

SERVE_ARCHS = ("small-gpt", "mamba2-2.7b:reduced")
SERVE_MESHES = {"tp": (1, 2), "dp": (2, 1)}


def _serve_counts(mesh, dmesh) -> dict:
    """Each serving step of this rank counted twice: run for real on the
    CPU over gloo (`mesh`), and traced on the meta device over a
    `DryComm` of the same rank (`dmesh`); with each mesh's collectives
    over the step."""
    from repro_torch.parallel.sharding import MeshAxes
    out = {}
    for arch in SERVE_ARCHS:
        api = build_model(resolve_config(arch))
        for kind in ("prefill", "decode"):
            shape = ShapeConfig("s", 32, 2, kind)
            rec = {}
            for dev, m in (("cpu", mesh), ("meta", dmesh)):
                b = steps.make_step(api, m, MeshAxes(), shape,
                                    attn_impl="torch", device=dev)
                before = m.comm.op_counts()
                ana = _count(b, dev)
                after = m.comm.op_counts()
                rec[dev] = {
                    "flops": ana.flops, "hbm": ana.hbm_bytes,
                    "dots": ana.dot_count, "kernels": ana.kernels,
                    "fsdp": b.fsdp,
                    "comm": {k: [v[0] - before.get(k, [0, 0])[0],
                                 v[1] - before.get(k, [0, 0])[1]]
                             for k, v in after.items()}}
            out[(arch, kind)] = rec
    return out


def _serve_worker(rank, port, d):
    import pickle
    import traceback
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.comm import init_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        out = {}
        for name, shape in SERVE_MESHES.items():
            mesh = init_mesh(shape, ("data", "model"), device="cpu")
            dmesh = make_test_mesh(shape, rank=rank, dry=True)
            budget = steps.SERVE_TP_ONLY_BUDGET
            if name == "dp":
                steps.SERVE_TP_ONLY_BUDGET = -1      # fsdp: the gathers
            try:
                out[name] = _serve_counts(mesh, dmesh)
            finally:
                steps.SERVE_TP_ONLY_BUDGET = budget
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def serve_counts(tmp_path_factory):
    import pickle
    import socket
    import torch.multiprocessing as mp
    d = str(tmp_path_factory.mktemp("serve_counts"))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    mp.start_processes(_serve_worker, args=(port, d), nprocs=2,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[r], ranks[r]["error"]
    return ranks


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", sorted(SERVE_MESHES))
def test_a_serving_rank_counts_the_same_on_meta_and_gloo(serve_counts,
                                                        mesh, kind):
    """A serving rank of a 1x2 (TP-only) and a 2x1 (fsdp) mesh: its meta
    trace over a `DryComm` counts what its CPU step over gloo counts, in
    FLOPs, HBM bytes, products and kernel calls, and the collectives
    (calls and bytes by op and group size) are the same."""
    for res in serve_counts:
        for arch in SERVE_ARCHS:
            rec = res[mesh][(arch, kind)]
            cpu, meta = rec["cpu"], rec["meta"]
            assert meta["flops"] == cpu["flops"] > 0
            assert meta["hbm"] == cpu["hbm"] > 0
            assert meta["dots"] == cpu["dots"]
            assert meta["kernels"] == cpu["kernels"]
            assert meta["comm"] == cpu["comm"]
            assert meta["fsdp"] == cpu["fsdp"] == (mesh == "dp")
            # tp: the blocks' all-reduces and the logits' gather; dp
            # under fsdp: the weights' gathers
            assert any(v[0] for v in cpu["comm"].values())


@pytest.mark.parametrize("arch", ["small-gpt", "small-bert",
                                  "qwen2.5-3b:reduced"])
def test_flops_match_the_compiled_jax_step(arch):
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.hlo_stats import analyze_hlo
    from repro.launch.mesh import make_test_mesh, mesh_axes
    from repro.launch.steps import make_train_step as jmake
    from repro.models.api import build_model as jbuild
    from repro.optim.optimizers import sgd as jsgd
    from repro.session.session import resolve_config as jresolve
    mesh = make_test_mesh((1, 1))
    b = jmake(jbuild(jresolve(arch)), mesh, mesh_axes(mesh), jsgd(),
              JShape("t", 64, 2, "train"), activation_policy="keep",
              ce_chunk=0)
    with mesh:
        want = analyze_hlo(jax.jit(b.fn).lower(*b.args).compile().as_text(),
                           1)
    got = _count(steps.make_train_step(
        build_model(resolve_config(arch)), None, None, sgd(),
        ShapeConfig("t", 64, 2, "train"), activation_policy="keep",
        ce_chunk=0, attn_impl="torch", device="meta"), "meta")
    assert abs(got.flops / want.flops - 1) <= 0.01
    assert got.dot_count == want.dot_count


# --------------------------------------------------------- the dry run

JAX_RECORD_KEYS = {
    "arch", "shape", "mesh", "multi_pod", "kind", "seq_len",
    "global_batch", "policy", "attn_chunk", "optimizer", "status", "fsdp",
    "n_params", "n_active", "tokens_per_step", "lower_s", "compile_s",
    "memory_analysis", "xla_cost_analysis", "hlo", "roofline",
    "predicted_overlap", "predicted_residency"}


def test_a_production_cell_runs_on_meta(tmp_path):
    from repro.launch.hlo_stats import HloAnalysis
    from repro_torch.launch import dryrun
    t0 = time.time()
    rec = dryrun.run_cell("qwen2.5-3b", "train_4k", multi_pod=False,
                          out_dir=str(tmp_path), force=True)
    assert time.time() - t0 < 30
    assert rec["status"] == "ok", rec.get("traceback")
    assert JAX_RECORD_KEYS <= set(rec)
    assert set(HloAnalysis().as_dict()) <= set(rec["hlo"])
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "host_argument_bytes", "host_temp_bytes",
            "peak_device_bytes"} == set(rec["memory_analysis"])
    rl = rec["roofline"]
    assert rl["chips"] == 256 and rl["dominant"] in (
        "compute", "memory", "collective")
    assert rl["t_compute_s"] == rl["flops_per_device"] / 989e12
    assert rl["t_memory_s"] == rl["hbm_bytes_per_device"] / 3.35e12
    h = rec["hlo"]
    # fsdp gathers and reduce-scatters over "data", tp all-reduces
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        h["collectives"])
    assert h["host_bytes"] > 0 and h["kernels"]["flash_attention"][
        "calls"] == 2 * 36          # forward and recompute, 36 layers
    mem = rec["memory_analysis"]
    # the parameters and moments come back updated in place
    assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    assert os.path.exists(tmp_path / "qwen2_5-3b__train_4k__single.json")


def test_serving_cells_run_on_the_mesh_and_skips_keep_their_reason(
        tmp_path):
    """qwen2.5-3b's prefill_32k and decode_32k on the production mesh:
    status ok, TP-only (3 GB of bf16 weights over 16 ranks is under the
    budget, as JAX decides), the tensor axis's collectives; hubert's
    decode_32k is still skipped with `cell_skip_reason`'s words."""
    from repro_torch.launch import dryrun
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen2.5-3b", shape, multi_pod=False,
                              out_dir=str(tmp_path), force=True)
        assert rec["status"] == "ok", rec.get("traceback")
        assert JAX_RECORD_KEYS <= set(rec)
        assert rec["fsdp"] is False and rec["kind"] == shape.split("_")[0]
        assert "all-reduce" in rec["hlo"]["collectives"]
        assert "all-gather" in rec["hlo"]["collectives"]    # the logits
        assert rec["memory_analysis"]["peak_device_bytes"] > 0
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", multi_pod=False,
                          out_dir=str(tmp_path), force=True)
    assert rec["status"] == "skip"
    assert rec["skip_reason"] == cell_skip_reason(
        get_config("hubert-xlarge"), SHAPES["decode_32k"])


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-2.7b", "long_500k"), ("recurrentgemma-9b", "decode_32k"),
    ("gemma2-27b", "prefill_32k"), ("qwen2.5-3b", "long_500k")])
def test_a_serving_cell_of_each_kind_on_the_mesh(tmp_path, arch, shape):
    """mamba2's SSM heads and recurrentgemma's RG-LRU width split over
    the 16 "model" ranks at 524k and 32k tokens, gemma2's window ring at
    prefill; full attention at 524k keeps `cell_skip_reason`'s skip."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, multi_pod=False,
                          out_dir=str(tmp_path), force=True)
    reason = cell_skip_reason(get_config(arch), SHAPES[shape])
    if reason is not None:
        assert rec["status"] == "skip" and rec["skip_reason"] == reason
        return
    assert rec["status"] == "ok", rec.get("traceback")
    rl = rec["roofline"]
    assert rl["flops_per_device"] > 0 and rl["t_collective_s"] > 0


def test_a_mesh_the_port_refuses_is_skipped_with_its_reason(tmp_path):
    """llama4-scout's 40 query heads over 16 "model" ranks: JAX's rules
    replicate them, the port refuses the mesh (`check_mesh_config`)."""
    from repro_torch.core.meshrun import check_mesh_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, mesh_axes
    cfg = get_config("llama4-scout-17b-a16e")
    mesh = make_production_mesh()
    with pytest.raises(ValueError, match="40 query heads"):
        check_mesh_config(cfg, mesh, mesh_axes(mesh))
    rec = dryrun.run_cell("llama4-scout-17b-a16e", "train_4k",
                          multi_pod=False, out_dir=str(tmp_path),
                          force=True)
    assert rec["status"] == "skip" and "40 query heads" in rec["skip_reason"]
