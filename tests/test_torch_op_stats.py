"""The port's op-level analysis (`repro_torch.launch.op_stats`), the
kernels' work reports and the collectives' counters, on the CPU:

  * small hand-built programs on the meta device: the products' FLOPs
    (mm, bmm, addmm, einsum, linear), views and metadata ops free, the
    operands and results of what moves data, the live peak;
  * the host tier's and the spool's bytes off the device in an engine
    step on the meta device;
  * the ring cost of each collective against the JAX analysis's
    `_wire_bytes`, for each op and group size;
  * each kernel wrapper's meta path reports its `work(...)`, the one
    count of its work (flash: only the unmasked pairs);
  * `DryComm`'s counters against a real 2-rank gloo `Comm`'s over one
    step of a small mesh run, on (1, 2) and (2, 1).
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

from repro_torch.launch import op_stats
from repro_torch.launch.op_stats import OpCounter, wire_bytes

F32 = 4


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("form", ["mm", "matmul", "linear", "einsum",
                                  "addmm"])
def test_product_flops_and_bytes(form):
    x, w, bias = _meta(8, 16), _meta(16, 32), _meta(32)
    with OpCounter("meta") as c:
        if form == "mm":
            y = torch.mm(x, w)
        elif form == "matmul":
            y = x @ w
        elif form == "linear":
            y = torch.nn.functional.linear(x, w.t())
        elif form == "einsum":
            y = torch.einsum("ik,kj->ij", x, w)
        else:
            y = torch.addmm(bias, x, w)
    a = c.analysis()
    assert tuple(y.shape) == (8, 32)
    assert a.flops == 2 * 8 * 16 * 32
    assert a.dot_count == 1
    want = F32 * (8 * 16 + 16 * 32 + 8 * 32 + (32 if form == "addmm" else 0))
    assert a.hbm_bytes == a.hbm_bytes_lb == want


def test_batched_products_count_every_batch():
    q, k = _meta(2, 3, 5, 7), _meta(2, 3, 7, 4)
    with OpCounter("meta") as c:
        torch.einsum("bhqd,bhdk->bhqk", q, k)
        torch.baddbmm(_meta(6, 5, 4), _meta(6, 5, 7), _meta(6, 7, 4))
    a = c.analysis()
    assert a.flops == 2 * (2 * 3) * 5 * 7 * 4 * 2
    assert a.dot_count == 2


def test_views_and_metadata_are_free_and_elementwise_has_no_flops():
    x = _meta(8, 16)
    with OpCounter("meta") as c:
        v = x.view(16, 8).t()[1:].unsqueeze(0).expand(2, -1, -1)
        x.detach()
        torch.empty(100, device="meta")
    assert c.analysis().hbm_bytes == 0
    with OpCounter("meta") as c:
        (v + 1.0).exp()
    a = c.analysis()
    assert a.flops == 0 and a.dot_count == 0
    # add: reads the (2, 7, 16) view, writes its sum; exp reads and
    # writes
    assert a.hbm_bytes == 4 * F32 * 2 * 7 * 16


def test_live_peak_counts_storages_until_freed():
    with OpCounter("meta") as c:
        a = torch.empty(1000, device="meta")
        b = torch.empty(500, device="meta")
        view = a[10:20]                          # no new storage
        del a, view
        d = torch.empty(250, device="meta")
        del b, d
    assert c.analysis().peak_bytes == F32 * 1500


def test_uncounted_work_moves_nothing():
    x, w = _meta(8, 16), _meta(16, 32)
    with OpCounter("meta") as c:
        with op_stats.uncounted():
            x @ w
    a = c.analysis()
    assert a.flops == a.hbm_bytes == a.peak_bytes == 0


@pytest.mark.parametrize("policy", ["offload", "spool"])
def test_engine_reports_the_bytes_it_moves_off_the_device(policy):
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import sgd
    cfg = resolve_config("small-gpt")
    B, S = 2, 32
    b = make_train_step(build_model(cfg), None, None, sgd(),
                        ShapeConfig("t", S, B, "train"),
                        activation_policy=policy, attn_impl="torch",
                        device="meta")
    try:
        with OpCounter("meta") as c:
            c.track(b.args)
            _, _, m = b.fn(*b.args)
    finally:
        b.close()
    rep = m["report"]
    if policy == "offload":
        # the host tier: each layer stage's input, B x S x D
        itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)
                               ).element_size()
        want = cfg.num_layers * B * S * cfg.d_model * itemsize
        assert rep.extra["stages_host"] == cfg.num_layers
    else:
        want = rep.extra["layer_saved_bytes"]
        assert rep.extra["stages_offloaded"] == cfg.num_layers
    assert want > 0 and c.analysis().host_bytes == want


@pytest.mark.parametrize("n", [1, 2, 8, 16, 256])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "all-to-all",
                                "collective-permute",
                                "collective-broadcast"])
def test_wire_bytes_are_the_jax_ring_costs(op, n):
    from repro.launch.hlo_stats import _wire_bytes
    for r in (1, 4096, 3 << 20):
        assert wire_bytes(op, r, n) == _wire_bytes(op, r, n)


def test_every_comm_op_maps_to_an_hlo_collective_or_to_no_wire():
    from repro.launch.hlo_stats import COLLECTIVE_OPS
    assert set(op_stats.HLO_COLLECTIVE.values()) <= set(COLLECTIVE_OPS)


def test_dry_comm_counts_each_logical_collective_once():
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2), dry=True)
    comm = mesh.comm
    t = _meta(4, 8)
    with OpCounter("meta") as c:
        out = comm.all_reduce_sum(t, ("model",))
        parts = comm.all_gather(t, ("data", "model"))
        rs = comm.reduce_scatter_sum(t, ("data",), 0)
    assert out.shape == t.shape and out.device.type == "meta"
    assert len(parts) == 4 and rs.shape == (2, 8)
    # the all-reduce's own reduce-scatter and all-gather are not counted
    assert comm.op_counts() == {"all_reduce_sum@2": [1, 128],
                                "all_gather@4": [1, 512],
                                "reduce_scatter_sum@2": [1, 64]}
    a = c.analysis()
    assert a.collectives["all-reduce"].wire_bytes == 128 * 2 * 1 / 2
    assert a.collectives["all-gather"].wire_bytes == 512 * 3 / 4
    assert a.collectives["reduce-scatter"].wire_bytes == 64 * 1
    assert a.wire_by_group_size == {2: 128.0 + 64.0, 4: 384.0}
    # off the meta device each member holds what this one holds
    x = torch.ones(3)
    assert torch.equal(comm.all_reduce_sum(x, ("model",)), 2 * x)
    assert comm.gather_objects("o") == ["o"] * 4


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (1, 1, True, 0), (64, 64, True, 0), (64, 64, False, 0),
    (100, 37, True, 0), (37, 100, False, 0), (128, 128, True, 16),
    (64, 200, True, 7), (300, 300, False, 50)])
def test_flash_work_counts_only_the_unmasked_pairs(Sq, Skv, causal, window):
    from repro_torch.kernels.flash_attention import unmasked_pairs, work
    want = 0
    for r in range(Sq):
        hi = min(Skv, r + 1) if causal else Skv
        lo = max(0, r - window + 1) if window else 0
        want += max(0, hi - lo)
    assert unmasked_pairs(Sq, Skv, causal, window) == want
    q, kv = _meta(2, Sq, 4, 32), _meta(2, Skv, 2, 32)
    w = work(q, kv, kv, causal=causal, window=window)
    assert w.flops == 4 * 2 * 4 * 32 * want
    assert w.bytes == F32 * (2 * q.numel() + 2 * kv.numel())


def test_kernel_wrappers_report_their_work_on_meta():
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.flash_attention import flash_attention, work
    q, kv = _meta(1, 64, 4, 32, dtype=torch.bfloat16), \
        _meta(1, 64, 1, 32, dtype=torch.bfloat16)
    xh, a, bc = _meta(1, 64, 2, 16), _meta(1, 64, 2), _meta(1, 64, 8)
    la = _meta(2, 64, 16, dtype=torch.float32).requires_grad_()
    x = _meta(2, 64, 16).requires_grad_()
    with OpCounter("meta") as c:
        flash_attention(q, kv, kv, causal=True, window=8)
        ssd.ssd_scan(xh, a, bc, bc, chunk=16)
        rg.rglru_scan(la, x).sum().backward()
    k = c.analysis().kernels
    fw = work(q, kv, kv, causal=True, window=8)
    assert k["flash_attention"] == {"calls": 1, "flops": fw.flops,
                                    "bytes": fw.bytes}
    sw = ssd.work(xh, a, bc, bc, 16)
    assert k["ssd_scan"] == {"calls": 1, "flops": sw.flops,
                             "bytes": sw.bytes}
    # forward (log_a, x, h) and the fused backward (log_a, g, h, dx,
    # dlog_a)
    assert k["rglru_scan"] == {"calls": 2,
                               "flops": 2 * rg.work(x).flops,
                               "bytes": rg.work(x, 3).bytes
                               + rg.work(x, 5).bytes}
    assert rg.rglru_scan.launches == 0 and ssd.ssd_scan.launches == 0


# ------------------------------------------------------ DryComm vs gloo

WORLD, B, S = 2, 2, 32
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_counts(rank: int) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.paper_models import small_gpt
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.parallel.comm import init_mesh
    from repro_torch.parallel.sharding import MeshAxes
    api = build_model(dataclasses.replace(small_gpt(128, 2),
                                          dtype="float32"))
    shape = ShapeConfig("t", S, B, "train")
    out = {}
    for name, dims in MESHES.items():
        mesh = init_mesh(dims, ("data", "model"), device="cpu")
        real = make_train_step(api, mesh, MeshAxes(), sgd(1e-3), shape,
                               attn_impl="torch", device="cpu")
        before = mesh.comm.op_counts()
        real.fn(*real.args)
        real.close()
        card = {k: [v[0] - before.get(k, [0, 0])[0],
                    v[1] - before.get(k, [0, 0])[1]]
                for k, v in mesh.comm.op_counts().items()}
        dmesh = make_test_mesh(dims, ("data", "model"), rank=rank, dry=True)
        dry = make_train_step(api, dmesh, MeshAxes(), sgd(1e-3), shape,
                              attn_impl="torch", device="meta")
        dry.fn(*dry.args)
        dry.close()
        out[name] = ({k: v for k, v in card.items() if v[0]},
                     dmesh.comm.op_counts())
    return out


def _worker(rank, port, d):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        out = _rank_counts(rank)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def rank_counts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("op_stats_ranks"))
    mp.start_processes(_worker, args=(_free_port(), d), nprocs=WORLD,
                       start_method="spawn")
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    for r, res in enumerate(out):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    return out


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dry_comm_counts_what_a_gloo_comm_moves(rank_counts, mesh, rank):
    card, dry = rank_counts[rank][mesh]
    assert card, "the step ran no collective"
    assert card == dry
    # the tensor axis all-reduces; fsdp gathers and reduce-scatters
    ops = {k.split("@")[0] for k in card}
    if mesh == "1x2":
        assert "all_reduce_sum" in ops
    else:
        assert {"all_gather", "reduce_scatter_sum"} <= ops
    assert np.all([v[1] > 0 for v in card.values()])
