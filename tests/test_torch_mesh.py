"""The port's mesh rules against the JAX package's, in process (no ranks):

  * `parallel/sharding.py`: `param_specs` (fsdp on and off),
    `batch_specs` and `cache_specs` of every registry id, leaf for leaf,
    on stub meshes of (2, 2) and (2, 4) ("data", "model"), as
    `tests/test_hooks.py` stubs a mesh (an object with `shape` and
    `axis_names`);
  * `core/hooks.py::plan_shards` on `tests/test_hooks.py`'s cases;
  * `optim/optimizers.py::zero1_shardings`;
  * `core/policies.py::local_shard_fraction` and
    `AdaptivePolicy.plan_for_jit(shard_fraction=...)`, the plans equal to
    the JAX package's for the same profiles;
  * the spool's `consumers` countdown and the bridge's bounded wait for a
    late store, from threads (mirroring `tests/test_hooks.py:322-392`);
  * the mesh's arithmetic (`parallel/mesh.py`) and the blob names of
    keys with a `/`.
"""
import functools
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.registry import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro.core.adaptive import ModuleProfile as JProfile  # noqa: E402
from repro.core.hooks import plan_shards as jplan_shards  # noqa: E402
from repro.core.policies import AdaptivePolicy as JAdaptive  # noqa: E402
from repro.core.policies import \
    local_shard_fraction as jlocal_fraction  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.optim.optimizers import zero1_shardings as jzero1  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.core.adaptive import ModuleProfile  # noqa: E402
from repro_torch.core.hooks import HookBridge, plan_shards  # noqa: E402
from repro_torch.core.policies import (AdaptivePolicy,  # noqa: E402
                                       local_shard_fraction)
from repro_torch.core.spool import ActivationSpool  # noqa: E402
from repro_torch.io.backends import (FilesystemBackend,  # noqa: E402
                                     HostMemoryBackend)
from repro_torch.optim.optimizers import zero1_shardings  # noqa: E402
from repro_torch.parallel import mesh as tmesh  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

MESHES = {"2x2": {"data": 2, "model": 2}, "2x4": {"data": 2, "model": 4}}


def _stub(shape):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _norm(spec):
    """A JAX PartitionSpec or a port spec as a tuple of entries, 1-tuples
    as bare names (newer jax canonicalises them so)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _jax_flat(tree):
    """[(path names, normalised spec)] of a JAX spec tree."""
    P = jax.sharding.PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), _norm(s)) for path, s in flat]


def _port_flat(tree):
    out = []
    tsh.map_with_path(lambda path, s: out.append((path, _norm(s))), tree)
    return sorted(out)


def _as_port_tree(tree):
    """A JAX shape tree as nested dicts / lists of objects with .shape."""
    if isinstance(tree, dict):
        return {k: _as_port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_port_tree(v) for v in tree]
    return SimpleNamespace(shape=tuple(tree.shape))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = get_config(arch)
    api = jbuild(cfg)
    params = jax.eval_shape(api.init, jax.random.key(0))
    return cfg, params, api.input_specs(SHAPES["train_4k"]), \
        api.input_specs(SHAPES["decode_32k"]), \
        api.input_specs(SHAPES["long_500k"])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_leaf_for_leaf(arch, mesh_name):
    cfg, params, train, decode, long = _shapes(arch)
    mesh = _stub(MESHES[mesh_name])
    jaxes, taxes = jsh.MeshAxes(), tsh.MeshAxes()
    port_params = _as_port_tree(params)
    for fsdp in (True, False):
        want = sorted(_jax_flat(jsh.param_specs(cfg, params, mesh, jaxes,
                                                fsdp=fsdp)))
        got = _port_flat(tsh.param_specs(cfg, port_params, mesh, taxes,
                                         fsdp=fsdp))
        assert got == want, (arch, mesh_name, fsdp)
    for specs in (train, decode, long):
        for part, fn, tfn in (("batch", jsh.batch_specs, tsh.batch_specs),
                              ("cache", jsh.cache_specs, tsh.cache_specs)):
            if part not in specs:
                continue
            want = sorted(_jax_flat(fn(specs[part], mesh, jaxes)))
            got = _port_flat(tfn(_as_port_tree(specs[part]), mesh, taxes))
            assert got == want, (arch, mesh_name, part)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b",
                                  "kimi-k2-1t-a32b"])
def test_zero1_shardings_match_jax(arch):
    cfg, params, *_ = _shapes(arch)
    mesh = _stub(MESHES["2x4"])
    for fsdp in (True, False):
        jspecs = jsh.param_specs(cfg, params, mesh, jsh.MeshAxes(),
                                 fsdp=fsdp)
        tspecs = tsh.param_specs(cfg, _as_port_tree(params), mesh,
                                 tsh.MeshAxes(), fsdp=fsdp)
        want = sorted(_jax_flat(jzero1(jspecs, ("data",))))
        assert _port_flat(zero1_shardings(tspecs, ("data",))) == want


def test_optimizer_state_specs_inherit_the_parameters():
    from repro_torch.optim.optimizers import OptState
    specs = {"w": ("data", "model"), "s": (None,)}
    st = tsh.spec_tree_for_optstate(specs, OptState(0, {"w": 1}, None))
    assert st.step == () and st.mu is specs and st.nu is None


def test_plan_shards_specs_and_replica_factorization():
    """Leaf spec choice: leading dim over dp when divisible, innermost
    other divisible dim over tp; axes sharding nothing become replica
    axes — the cases of `tests/test_hooks.py`, against the JAX plan."""
    mesh = _stub({"data": 2, "model": 4})
    shapes = [(8, 32, 128), (8, 32, 3), (8, 3, 3), ()]
    sds = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
    plan = plan_shards(mesh, ("data",), "model", shapes)
    want = jplan_shards(mesh, ("data",), "model", sds)
    assert [_norm(s) for s in plan.specs] == [_norm(s) for s in want.specs]
    assert plan.specs == (("data", None, "model"), ("data", "model", None),
                          ("data", None, None), ())
    assert plan.writer_axes == want.writer_axes == ("data", "model")
    assert plan.replica_axes == want.replica_axes == ()
    assert plan.n_shards == 8 and plan.n_replicas == 1
    assert plan.local_shapes(shapes)[:3] == ((4, 32, 32), (4, 8, 3),
                                             (4, 3, 3))
    # batch indivisible by dp, no tp -> one replica group
    plan2 = plan_shards(mesh, ("data",), None, [(3, 5)])
    want2 = jplan_shards(mesh, ("data",), None,
                         [jax.ShapeDtypeStruct((3, 5), np.float32)])
    assert plan2.writer_axes == want2.writer_axes == ()
    assert plan2.replica_axes == want2.replica_axes == ("data", "model")
    assert plan2.n_shards == 1 and plan2.n_replicas == 8


def _profiles(cls):
    return [cls(f"seg0_l{i}", 100 << 20, 0.01) for i in range(6)]


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_plan_for_jit_shard_fraction_matches_jax(fraction):
    pol, jpol = AdaptivePolicy(), JAdaptive()
    pol.on_profile(_profiles(ModuleProfile), 2.0e9)
    jpol.on_profile(_profiles(JProfile), 2.0e9)
    got = pol.plan_for_jit(shard_fraction=fraction)
    want = jpol.plan_for_jit(shard_fraction=fraction)
    assert got.spool_stages == want.spool_stages
    assert got.activation_policy == want.activation_policy
    assert got.shard_fraction == want.shard_fraction == fraction
    assert got.required_bw == pytest.approx(want.required_bw, rel=1e-12)
    full = pol.plan_for_jit()
    assert sum(got.spool_stages) >= sum(full.spool_stages)
    with pytest.raises(ValueError):
        pol.plan_for_jit(shard_fraction=0.0)


def test_local_shard_fraction():
    mesh = _stub({"data": 4, "model": 2})
    assert local_shard_fraction(None) == jlocal_fraction(None) == 1.0
    for axes in (("data",), ("model",), ("data", "model"), ()):
        assert local_shard_fraction(mesh, axes) == \
            jlocal_fraction(mesh, axes)
    assert local_shard_fraction(mesh, ("data",)) == 0.25


# ------------------------------------------------ the bridge, threads


def _spool():
    return ActivationSpool(HostMemoryBackend(), min_offload_elements=4,
                           store_threads=1, load_threads=1)


def test_bridge_replica_countdown_consume():
    """A stage fetched once per replica shard is dropped by the last
    fetch only: earlier fetches peek, and the lease closes once every
    stage of the shard is consumed."""
    spool = _spool()
    bridge = HookBridge(spool, fetch_timeout=5.0)
    arrays = [torch.from_numpy(np.random.default_rng(0).normal(
        size=(256,)).astype(np.float32))]
    bridge.sharded_offload(0, 0, arrays, shard=0, replica=0, n_replicas=3)
    bridge.sharded_offload(0, 0, arrays, shard=0, replica=1,
                           n_replicas=3)     # dedup: skipped
    spool.wait_io()
    for rep in range(3):
        out = bridge.sharded_fetch(0, 0, shard=0, replica=rep,
                                   n_replicas=3)
        assert torch.equal(out[0], arrays[0])
        live = bridge._txs.get("jit0/s0")
        if rep < 2:
            assert live is not None and live.has_stage(0)
        else:
            assert live is None          # the last consumer closed it
    assert not spool._records
    stats = bridge.stats_by_shard()[0]
    assert stats["offloads"] == 1 and stats["replica_skips"] == 1
    assert stats["fetches"] == 3
    assert stats["bytes_out"] == 3 * stats["bytes_in"] == 3 * 1024
    # a 4th fetch of the consumed stage is an error, not a hang
    bridge.fetch_timeout = 0.2
    with pytest.raises(KeyError):
        bridge.sharded_fetch(0, 0, shard=0, replica=0, n_replicas=3)
    spool.close()


def test_bridge_dedupe_disabled_stores_per_replica():
    spool = _spool()
    bridge = HookBridge(spool, dedupe_replicas=False, fetch_timeout=5.0)
    g = torch.Generator().manual_seed(1)
    for rep in range(2):
        bridge.sharded_offload(0, 0, [torch.randn(64, generator=g)],
                               shard=1, replica=rep, n_replicas=2)
    spool.wait_io()
    assert spool.stats.num_stores == 2   # one blob per replica
    assert sorted(bridge.stats_by_shard()) == [2, 3]
    for rep in range(2):
        bridge.sharded_fetch(0, 0, shard=1, replica=rep, n_replicas=2)
    assert not bridge._txs and not spool._records
    spool.close()


def test_bridge_fetch_waits_for_late_offload():
    """A fetch that beats its store waits for it (bounded), then reads."""
    spool = _spool()
    bridge = HookBridge(spool, fetch_timeout=10.0)
    arr = torch.arange(64, dtype=torch.float32)

    def late_offload():
        time.sleep(0.3)
        bridge.offload(7, 0, [arr], shard=2)

    t = threading.Thread(target=late_offload)
    t.start()
    t0 = time.perf_counter()
    out = bridge.fetch(7, 0, shard=2)    # arrives first, waits
    t.join()
    assert time.perf_counter() - t0 >= 0.25
    assert torch.equal(out[0], arr)
    assert not bridge._txs
    spool.close()


def test_bridge_concurrent_shards_account_exactly():
    """Offload / fetch from 4 threads across interleaved steps: every
    lease closes, and each record's bytes are forwarded or loaded back,
    exactly once."""
    n_shards, n_steps, n_stages = 4, 3, 3
    spool = ActivationSpool(HostMemoryBackend(), min_offload_elements=4,
                            store_threads=2, load_threads=2)
    bridge = HookBridge(spool, fetch_timeout=30.0)
    g = torch.Generator().manual_seed(2)
    data = {(s, st, sh): torch.randn(512, generator=g)
            for s in range(n_steps) for st in range(n_stages)
            for sh in range(n_shards)}
    errors = []

    def device_thread(shard):
        try:
            for step in range(n_steps):
                for stage in range(n_stages):
                    bridge.offload(step, stage, [data[(step, stage, shard)]],
                                   shard=shard)
                for stage in reversed(range(n_stages)):
                    out = bridge.fetch(step, stage, shard=shard)
                    assert torch.equal(out[0], data[(step, stage, shard)])
        except BaseException as e:       # pragma: no cover - fails test
            errors.append(e)

    threads = [threading.Thread(target=device_thread, args=(sh,))
               for sh in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spool.wait_io()
    assert not errors, errors
    assert not bridge._txs and not spool._records
    total = n_shards * n_steps * n_stages
    by_shard = bridge.stats_by_shard()
    assert sorted(by_shard) == list(range(n_shards))
    assert sum(v["offloads"] for v in by_shard.values()) == total
    assert sum(v["fetches"] for v in by_shard.values()) == total
    st, per_rec = spool.stats, 512 * 4
    assert st.num_stores + st.stores_canceled == total
    assert st.bytes_forwarded % per_rec == 0
    assert st.num_loads == total - st.bytes_forwarded // per_rec
    spool.close()


def test_a_consumed_peek_leaves_no_device_copy_and_release_drops():
    """`consume` with consumers left peeks without cancelling the store;
    `release` counts a reader that read the blob itself; the last one
    drops the record and its blob."""
    spool = _spool()
    tx = spool.step("jit0/s0")
    arr = torch.arange(32, dtype=torch.float32)
    tx.offload(1, [arr], consumers=3)
    assert torch.equal(tx.consume(1)[0], arr)
    assert tx.consumers_left(1) == 2 and tx.has_stage(1)
    spool.wait_io()
    assert spool.stats.num_stores == 1 and spool.stats.stores_canceled == 0
    tx.release(1)
    assert tx.has_stage(1) and spool.backend.keys() == ["jit0/s0_s1"]
    tx.release(1)
    assert not tx.has_stage(1) and spool.backend.keys() == []
    with pytest.raises(KeyError):
        tx.release(1)
    tx.close()
    spool.close()


# ----------------------------------------------------- mesh arithmetic


def test_mesh_coordinates_groups_and_local_shapes():
    m = tmesh.make_test_mesh((2, 4), ("data", "model"), rank=6)
    assert m.coords == {"data": 1, "model": 2} and m.size == 8
    assert tmesh.linear_axis_index(m, ("data", "model")) == 6
    assert tmesh.linear_axis_index(m, ("model", "data")) == 5
    assert tmesh.linear_axis_index(m, ()) == 0
    assert m.group_ranks(("model",)) == (4, 5, 6, 7)
    assert m.group_ranks(("data",)) == (2, 6)
    assert m.all_groups(("data",)) == ((0, 4), (1, 5), (2, 6), (3, 7))
    assert tmesh.mesh_size(None) == 1 and tmesh.axes_size(m, ()) == 1
    spec = ("data", None, ("data", "model"))
    assert tmesh.spec_axes(spec) == ("data", "data", "model")
    assert tmesh.local_shape((8, 3, 16), spec, m) == (4, 3, 2)
    assert tmesh.canonical_axis_entry(()) is None
    assert tmesh.canonical_axis_entry(("data",)) == "data"
    assert tmesh.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert tmesh.parse_mesh("8") == ((8,), ("data",))
    for bad in ("2x", "0x2", "1x1x1x1"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh(bad)


def test_blob_names_keep_a_slash_out_of_the_path(tmp_path):
    fs = FilesystemBackend(str(tmp_path))
    for key in ("jit3/s1_s2", "mb0_s1", "a%2Fb"):
        fs.write(key, b"x")
    assert sorted(fs.keys()) == ["a%2Fb", "jit3/s1_s2", "mb0_s1"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "a%252Fb.act", "jit3%2Fs1_s2.act", "mb0_s1.act"]
    assert fs.read("jit3/s1_s2") == b"x"
    for key in fs.keys():
        fs.delete(key)
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("arch", [
    "mamba2-2.7b:reduced", "recurrentgemma-9b:reduced", "small-t5"])
def test_recurrent_and_encoder_decoder_archs_build_a_mesh_session(arch):
    """mamba2, recurrentgemma and T5 pass the mesh check (slice 12b part
    3): a session over a stub mesh gets as far as asking for its Comm."""
    from repro_torch.configs import small_t5
    from repro_torch.session import TrainSession
    cfg = small_t5() if arch == "small-t5" else arch
    with pytest.raises(ValueError, match="init_mesh"):
        TrainSession(cfg, engine="jit", device="cpu",
                     mesh=tmesh.make_test_mesh((1, 2)))


@pytest.mark.parametrize("arch,what", [
    ("mamba2-2.7b:reduced", "the 8 SSM heads of 16"),
    ("recurrentgemma-9b:reduced", "the RG-LRU width 64")])
def test_a_tensor_axis_that_does_not_divide_a_recurrent_block_is_refused(
        arch, what):
    """A tensor axis of 3 ranks splits neither mamba2's 8 heads nor the
    RG-LRU width 64: the session refuses it, naming the shapes, before it
    asks for the Comm; a block asked to run so raises the same."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.transformer import check_tensor_axis
    from repro_torch.session import TrainSession
    with pytest.raises(ValueError, match=f"3 ranks does not divide {what}"):
        TrainSession(arch, engine="jit", device="cpu",
                     mesh=tmesh.make_test_mesh((1, 3)))
    check_tensor_axis(resolve_config(arch), 2)
    with pytest.raises(ValueError, match=what):
        check_tensor_axis(resolve_config(arch), 3)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b:reduced",
                                  "llama4-scout-17b-a16e:reduced"])
def test_moe_archs_build_a_mesh_session(arch):
    """The MoE archs pass the mesh check (expert parallelism is in): a
    session over a stub mesh gets as far as asking for its Comm."""
    from repro_torch.core.meshrun import check_mesh_config
    from repro_torch.configs import resolve_config
    from repro_torch.session import TrainSession
    check_mesh_config(resolve_config(arch))
    with pytest.raises(ValueError, match="init_mesh"):
        TrainSession(arch, engine="jit", device="cpu",
                     mesh=tmesh.make_test_mesh((1, 2)))


def test_a_mesh_needs_the_jit_engine_and_no_overlap_or_checkpoints(tmp_path):
    """A mesh needs the jit engine. The optimizer overlap and checkpoints
    of a mesh run since slice 12b part 2 (tests/test_torch_mesh_overlap.py,
    tests/test_torch_mesh_ckpt.py): with either, a session over a stub
    mesh gets as far as asking for its Comm."""
    from repro_torch.session import TrainSession
    mesh = tmesh.make_test_mesh((2, 1))
    with pytest.raises(ValueError, match="jit-engine"):
        TrainSession("small-gpt", engine="staged", device="cpu", mesh=mesh)
    for kw in ({"opt_overlap": True}, {"ckpt_dir": str(tmp_path)}, {}):
        with pytest.raises(ValueError, match="init_mesh"):
            TrainSession("small-gpt", engine="jit", device="cpu", mesh=mesh,
                         **kw)


@pytest.mark.parametrize("arch", ["hubert-xlarge:reduced",
                                  "llama-3.2-vision-90b:reduced"])
def test_hubert_and_vision_build_a_mesh_session(arch):
    """Embeddings inputs and cross blocks pass the mesh check: a session
    over a stub mesh gets as far as asking for its Comm."""
    from repro_torch.configs import resolve_config
    from repro_torch.core.meshrun import check_mesh_config
    from repro_torch.data.pipeline import embedding_batches, vision_batches
    from repro_torch.session import TrainSession
    cfg = resolve_config(arch)
    check_mesh_config(cfg)
    loader = (embedding_batches(cfg.d_model, cfg.vocab_size, batch=2,
                                seq_len=8) if cfg.input_kind == "embeddings"
              else vision_batches(cfg.vocab_size, cfg.d_model,
                                  cfg.encoder_seq_len, batch=2, seq_len=8))
    with pytest.raises(ValueError, match="init_mesh"):
        TrainSession(arch, engine="jit", device="cpu", loader=loader,
                     mesh=tmesh.make_test_mesh((1, 2)))
