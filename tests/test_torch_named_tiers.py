"""The memory tiers' names inside a layer: `RunSettings.offload_names` of
"attn_out", "mlp_hidden" and "moe_hidden" (with or without "blk_in")
under the jit name's "offload" (`core/policies.py::HostTierPolicy`: the
named tensors in pinned host memory between a layer's forward and its
recompute) and "save_names" (`SaveNamesPolicy`: kept on the device),
marked by `models/marks.py`, on the CPU in float32:

  (a) jit sessions of the port and of the JAX package under the same
      policy and names, on the JAX init's weights: small-gpt(128, 3)
      with and without "blk_in", llama4-scout:reduced under
      "moe_hidden", llama-3.2-vision-90b:reduced at 4 layers (a stage of
      a self-attention and a cross block), recurrentgemma-9b:reduced at
      one period (rglru, rglru, attention: a hybrid stage); losses rtol
      1e-5, parameters rtol 2e-4 / atol 1e-4
      (`test_torch_host_tier.py::test_offload_matches_a_jax_offload_session`);
      llama4 trains with sgd: under adamw its keep run leaves JAX's bar
      only in elements whose gradient is zero to f32 rounding, which a
      one-step witness checks at two seeds;
  (b) each of them bitwise equal to the port's keep;
  (c) what one GPT block holds: the tensors JAX's
      `saved_residuals` lists for its block under the same policy,
      beyond the argument and the parameters (count, shapes), on the
      host under "offload" and on the device under "save_names";
  (d) the named tensors' device storages are freed while they lie on
      the host and come back bitwise; every pool lease comes back; no
      spool record, byte or file;
  (e) with "attn_out" held the recompute runs no attention forward (the
      held output's backward runs the plain one inside its VJP, as the
      kernel's backward does in every tier);
  (f) a meta-device step under "offload" counts exactly the named
      tensors' bytes as host bytes, as a CPU step does;
  (g) small-gpt on a 1x2 gloo mesh under "offload" of ("attn_out",
      "mlp_hidden") is bitwise equal to that mesh's keep, each rank
      holding its heads' and its d_ff columns' share.
"""
import dataclasses
import functools
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import SpoolIoConfig, resolve_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.paper_models import small_gpt
from repro_torch.core.engine import StagedEngine, _HostTier
from repro_torch.core.policies import HostTierPolicy, SaveNamesPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import vision_batches
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import steps
from repro_torch.launch.op_stats import OpCounter
from repro_torch.models import attention, marks
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (RunSettings, apply_block,
                                            build_segments, layer)
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import sgd
from repro_torch.session import TrainSession
from torch_one_thread import one_torch_thread  # noqa: E402,F401

B, S, SEED, LR = 2, 32, 3, 1e-3
ATTN_MLP = ("attn_out", "mlp_hidden")
TIERS = ("offload", "save_names")
#: case -> (arch, layers or None, names). The MoE case trains with sgd,
#: as `test_torch_moe.py` holds it to JAX: under adamw llama4's keep run
#: at SEED leaves the parameters' bar in an element whose gradient is
#: zero to f32 rounding
#: (`test_llama4_keep_leaves_jax_under_adamw_only_where_the_gradient_rounds`);
#: the others with adamw, as the host tier's test
SGD_CASES = ("llama4",)
CASES = {
    "gpt": ("small-gpt", None, ATTN_MLP),
    "gpt-blk_in": ("small-gpt", None, ("blk_in",) + ATTN_MLP),
    "llama4": ("llama4-scout-17b-a16e:reduced", None, ("moe_hidden",)),
    "vision": ("llama-3.2-vision-90b:reduced", 4, ATTN_MLP),
    "recurrentgemma": ("recurrentgemma-9b:reduced", 3, ATTN_MLP),
}


def _cfg(arch, layers, resolve):
    if arch == "small-gpt":
        cfg = resolve(128, 3)
    else:
        cfg = resolve(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def _port_cfg(case):
    arch, layers, _ = CASES[case]
    return _cfg(arch, layers, small_gpt if arch == "small-gpt"
                else resolve_config)


def _loader(cfg):
    if cfg.family != "vlm":
        return None
    return vision_batches(cfg.vocab_size, cfg.d_model, cfg.encoder_seq_len,
                          batch=B, seq_len=S, seed=SEED)


def _settings(policy, names=("blk_in",), impl="torch", **kw):
    return RunSettings(attn_impl=impl, attn_chunk=256,
                       param_dtype="float32", device="cpu",
                       activation_policy=policy, offload_names=names, **kw)


def _run(cfg, policy, names=("blk_in",), params=None, steps_=2,
         impl="torch", opt_sgd=False, seed=SEED, lr=LR):
    with TrainSession(cfg, engine="jit", device="cpu", batch_size=B,
                      seq_len=S, seed=seed, loader=_loader(cfg),
                      optimizer=(topt.sgd(lr) if opt_sgd
                                 else topt.adamw(lr, clip_norm=None)),
                      settings=_settings(policy, names, impl)) as s:
        if params is not None:
            s.params = params_from_jax(params, device="cpu")
            s.opt_state = s.optimizer.init(s.params)
        res = s.run(steps_)
        eng = s.engine
        return {"losses": res.losses, "reports": res.reports,
                "params": [t.detach().clone()
                           for t in tree_flatten(s.params)[0]],
                "policy": eng.policy, "spool": s.spool,
                "stats": eng.spool.stats,
                "written": eng.spool.backend.stats.bytes_written}


def _bitwise(a, b):
    assert a["losses"] == b["losses"], (a["losses"], b["losses"])
    assert len(a["params"]) == len(b["params"]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))


# ------------------------------------------------- (a), (b): the sessions

@functools.lru_cache(maxsize=None)
def _jax_session(case, policy, seed=SEED, steps_=2, opt_sgd=None, lr=LR):
    """(the JAX init's weights as numpy arrays, the JAX jit session's
    losses and final parameters) under `policy` and the case's names,
    `steps_` steps of sgd (`opt_sgd`; by default the case's optimizer) or
    adamw at `lr`."""
    jax = pytest.importorskip("jax")
    from repro.configs.paper_models import small_gpt as jax_small_gpt
    from repro.models.transformer import RunSettings as JaxSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession
    from repro.session.session import resolve_config as jax_resolve
    arch, layers, names = CASES[case]
    jcfg = _cfg(arch, layers, jax_small_gpt if arch == "small-gpt"
                else jax_resolve)
    if opt_sgd is None:
        opt_sgd = case in SGD_CASES
    jsess = JSession(jcfg, engine="jit", batch_size=B, seq_len=S, seed=seed,
                     lr=lr, optimizer=(jopt.sgd(lr) if opt_sgd
                                       else jopt.adamw(lr, clip_norm=None)),
                     loader=_loader(_port_cfg(case)), settings=JaxSettings(
                         attn_impl="xla", attn_chunk=256,
                         param_dtype="float32", activation_policy=policy,
                         offload_names=names))
    try:
        init = jax.tree.map(np.array, jsess.init().params)
        res = jsess.run(steps_)
        final = [np.asarray(x) for x in jax.tree.leaves(jsess.state.params)]
    finally:
        jsess.close()
    return init, res.losses, final


@functools.lru_cache(maxsize=None)
def _port_session(case, policy):
    init = _jax_session(case, "offload")[0]
    names = CASES[case][2] if policy != "keep" else ("blk_in",)
    return _run(_port_cfg(case), policy, names, params=init,
                opt_sgd=case in SGD_CASES)


@pytest.mark.parametrize("policy", TIERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_matches_a_jax_session(case, policy):
    _, jlosses, jparams = _jax_session(case, policy)
    got = _port_session(case, policy)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert len(got["params"]) == len(jparams)
    for a, b in zip(got["params"], jparams):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("policy", TIERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_tier_is_bitwise_keep(case, policy):
    got = _port_session(case, policy)
    _bitwise(got, _port_session(case, "keep"))
    names = CASES[case][2]
    pol = got["policy"]
    assert isinstance(pol, HostTierPolicy if policy == "offload"
                      else SaveNamesPolicy)
    assert pol.inner_names == tuple(n for n in names if n != "blk_in")
    assert pol.host_inputs == (policy == "offload" and "blk_in" in names)
    assert all(r.extra["named_bytes"] > 0 for r in got["reports"])
    # no spool record, byte or file
    assert got["spool"] is None and got["written"] == 0
    assert got["stats"].bytes_offloaded == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_llama4_keep_leaves_jax_under_adamw_only_where_the_gradient_rounds(
        seed):
    """Why the llama4 case trains with sgd. One keep step of
    llama4-scout:reduced (f32, B=2, S=32) from the JAX init, in both
    packages. Each gradient is read off one sgd step at lr GRAD_LR (w0 -
    w1 = lr g, large enough to stand above w0's rounding); the two
    packages' gradients agree within 1e-5 of the leaf's largest |g|
    (the sums' f32 order and the read-off's rounding). Under adamw (lr
    1e-3, eps 1e-8) an element may land past the parameters' bar of
    `test_the_port_matches_a_jax_session`, but only where both gradients
    are under 1e-7: adam's first step, lr g / (|g| + eps), turns the f32
    rounding of a near-zero gradient into a step of the order of lr.
    Prints the largest excess over the bar and the two gradients there."""
    import jax
    case, GRAD_LR = "llama4", 1e6
    cfg = _port_cfg(case)
    init, _, jsgd = _jax_session(case, "keep", seed, 1, True, GRAD_LR)
    _, _, jadam = _jax_session(case, "keep", seed, 1, False)
    psgd = _run(cfg, "keep", params=init, steps_=1, opt_sgd=True,
                seed=seed, lr=GRAD_LR)["params"]
    padam = _run(cfg, "keep", params=init, steps_=1, seed=seed)["params"]
    p0 = [np.asarray(x) for x in jax.tree.leaves(init)]
    assert len(p0) == len(psgd) == len(jsgd) == len(padam) == len(jadam)
    worst = (-np.inf, None)
    for i, (w0, ps, js, pa, ja) in enumerate(
            zip(p0, psgd, jsgd, padam, jadam)):
        gp = (w0.astype(np.float64) - ps.numpy()) / GRAD_LR
        gj = (w0.astype(np.float64) - js) / GRAD_LR
        np.testing.assert_allclose(gp, gj, rtol=0,
                                   atol=1e-5 * np.abs(gj).max())
        past = np.abs(pa.numpy() - ja) - (1e-4 + 2e-4 * np.abs(ja))
        miss = past > 0
        assert np.all(np.abs(gp[miss]) < 1e-7), (i, gp[miss])
        assert np.all(np.abs(gj[miss]) < 1e-7), (i, gj[miss])
        k = int(np.argmax(past))
        if past.flat[k] > worst[0]:
            worst = (float(past.flat[k]),
                     (i, w0.shape, k, gp.flat[k], gj.flat[k]))
    e, (i, shape, k, gp, gj) = worst
    print(f"seed {seed}: adamw's largest excess over the bar {e:.3e} at "
          f"leaf {i} {shape} element {k}, gradient port {gp:.3e} JAX "
          f"{gj:.3e}")


# ------------------------------------------------------ (c) what is held

def _jax_block_residuals(policy):
    """(shape, description) of what JAX's first small-gpt block saves
    under `policy` of ATTN_MLP, beyond its argument and parameters."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax._src.ad_checkpoint import saved_residuals
    from repro.configs.paper_models import small_gpt as jax_small_gpt
    from repro.models.transformer import RunSettings as JaxSettings
    from repro.models.transformer import apply_block as japply
    from repro.models.transformer import build_segments as jsegments
    from repro.models.transformer import remat_policy
    init = _jax_session("gpt", "offload")[0]
    jcfg = dataclasses.replace(jax_small_gpt(128, 3), dtype="float32")
    bdef = jsegments(jcfg)[0].blocks[0]
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), init["segments"][0])
    st = JaxSettings(attn_impl="xla", attn_chunk=256, param_dtype="float32",
                     activation_policy=policy, offload_names=ATTN_MLP)

    def f(p, x):
        return japply(bdef, p["b0"], x, jcfg, st, positions=jnp.arange(S),
                      aux={})[0].sum()

    x = jnp.ones((B, S, jcfg.d_model), jnp.float32)
    return [(tuple(a.shape), why) for a, why in saved_residuals(
        remat_policy(st)(f), p0, x)
        if not why.startswith(("from the argument", "from a constant"))]


@pytest.mark.parametrize("policy", TIERS)
def test_the_held_tensors_are_the_jax_blocks_residuals(policy,
                                                       monkeypatch):
    want = _jax_block_residuals(policy)
    cfg = _port_cfg("gpt")
    api = build_model(cfg)
    params = params_from_jax(_jax_session("gpt", "offload")[0],
                             device="cpu")
    # one block, recorded as the engine records a recomputed stage
    bdef = build_segments(cfg)[0].blocks[0]
    x = torch.ones((B, S, cfg.d_model))
    with torch.no_grad(), marks.recording(ATTN_MLP) as held:
        apply_block(bdef, layer(params["segments"][0], 0)["b0"], x, cfg,
                    _settings(policy), positions=torch.arange(S))
    assert [tuple(t.shape) for _, t in held] == [s for s, _ in want]
    assert [n for n, _ in held] == list(ATTN_MLP)
    if policy == "offload":
        # JAX's residuals are the policy's copies to pinned host memory
        assert all("device_put" in why for _, why in want)
    # the engine holds the same tensors, on the host or on the device
    eng = StagedEngine(api, _settings(policy, ATTN_MLP), sgd(LR),
                       policy=(HostTierPolicy if policy == "offload"
                               else SaveNamesPolicy)(ATTN_MLP),
                       io_config=SpoolIoConfig(backend="mem"),
                       engine_name="jit")
    seen = []
    real_hold = StagedEngine._hold

    def hold(self, tx, si, held, counts):
        out = real_hold(self, tx, si, held, counts)
        for name, t, key in out:
            n = t.numel() * t.element_size()
            recs = (self._host._held[si] if self._host is not None else [])
            on_host = any(r["t"] is t and r["host"].numel() == n
                          for r in recs)
            seen.append((si, name, tuple(t.shape),
                         t.untyped_storage().nbytes() == 0, on_host,
                         key in self.tracker._live))
        return out

    monkeypatch.setattr(StagedEngine, "_hold", hold)
    try:
        eng.train_step(params, eng.optimizer.init(params),
                       [{"tokens": np.zeros((B, S), np.int64),
                         "labels": np.zeros((B, S), np.int64)}])
    finally:
        eng.close()
    first = [x for x in seen if x[0] == seen[0][0]]
    assert len(seen) == 3 * len(first)
    assert [x[2] for x in first] == [s for s, _ in want]
    off = policy == "offload"
    assert all(x[3] == off and x[4] == off and x[5] != off for x in seen)


# ---------------------------------------------- (d) storage and leases

def test_named_tensors_lie_on_the_host_and_every_lease_comes_back(
        monkeypatch):
    cfg = _port_cfg("vision")
    api = build_model(cfg)
    names = ("blk_in",) + ATTN_MLP
    eng = StagedEngine(api, _settings("offload", names), sgd(LR),
                       policy=HostTierPolicy(names),
                       io_config=SpoolIoConfig(backend="mem"),
                       engine_name="jit")
    seen = []
    real_offload, real_restore = _HostTier.offload, _HostTier.restore

    def offload(self, si, t, key):
        before = t.detach().clone()
        real_offload(self, si, t, key)
        seen.append([si, key[1], t, before, t.untyped_storage().nbytes()])

    def restore(self, si):
        real_restore(self, si)
        for rec in seen:
            if rec[0] == si:
                rec.append(torch.equal(rec[2].detach(), rec[3]))

    monkeypatch.setattr(_HostTier, "offload", offload)
    monkeypatch.setattr(_HostTier, "restore", restore)
    params = api.init(torch.Generator().manual_seed(0))
    try:
        _, _, rep = eng.train_step(params, eng.optimizer.init(params),
                                   [next(_loader(cfg))])
        # two layer stages of a period: 1 attention block (its "attn_out"),
        # 2 dense MLPs (the cross block's too), and the stage's input
        assert rep.extra["stages_host"] == 2
        per_stage = sorted(r[1] for r in seen if r[0] == 2)
        assert per_stage == ["k", "n0", "n1", "n2"]
        assert [r[0] for r in seen] == [2] * 4 + [3] * 4
        assert all(r[4] == 0 and r[5] for r in seen)
        inner = sum(r[3].numel() * 4 for r in seen if r[1] != "k")
        assert rep.extra["named_bytes"] == inner
        pool = eng.spool.pool
        assert pool.stats()["peak_leased_bytes"] > 0
        assert pool._leased_bytes == 0
        assert eng.spool.live_keys() == []
        st = eng.spool.stats
        assert st.bytes_offloaded == st.bytes_loaded == 0
        assert eng.spool.backend.stats.bytes_written == 0
    finally:
        eng.close()


@pytest.mark.parametrize("policy", TIERS)
def test_the_recompute_lets_go_of_the_held_tensors(policy, monkeypatch):
    """Once a stage's recompute and backward have read its held tensors,
    nothing holds them: the device's copy is freed then, not at the
    step's end (a held tensor kept to the end sits beside the next
    stages' backward)."""
    import weakref
    cfg = _port_cfg("gpt")
    api = build_model(cfg)
    eng = StagedEngine(api, _settings(policy, ATTN_MLP), sgd(LR),
                       policy=(HostTierPolicy if policy == "offload"
                               else SaveNamesPolicy)(ATTN_MLP),
                       io_config=SpoolIoConfig(backend="mem"),
                       engine_name="jit")
    alive = []
    real = StagedEngine._recompute

    def recompute(self, *a, **kw):
        held = a[-1]
        refs = [weakref.ref(t) for _, t in held]
        out = real(self, *a, **kw)
        alive.append((len(refs), sum(r() is not None for r in refs)))
        return out

    monkeypatch.setattr(StagedEngine, "_recompute", recompute)
    params = api.init(torch.Generator().manual_seed(0))
    try:
        eng.train_step(params, eng.optimizer.init(params),
                       [{"tokens": np.zeros((B, S), np.int64),
                         "labels": np.zeros((B, S), np.int64)}])
    finally:
        eng.close()
    assert alive == [(2, 0)] * cfg.num_layers



# ----------------------------------- (e) no attention forward in recompute

@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_a_held_attn_out_runs_no_attention_forward(impl, monkeypatch):
    """With "attn_out" held, `attend` (an attention forward outside any
    VJP) runs once a layer a step, as in keep, where remat and the host
    tier of "blk_in" run it twice. The held output's backward runs the
    plain forward once more inside its VJP, once a layer: for "cuda" that
    is `flash_attention_vjp`, the kernel's own backward in every tier on
    the card; on the CPU the plain path keeps its autograd graph in keep,
    so there the plain attention runs as often as in remat."""
    cfg = _port_cfg("gpt")
    calls = {"attend": 0, "plain": 0, "vjp": 0}

    def counted(key, real):
        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return fn

    monkeypatch.setattr(attention, "attend",
                        counted("attend", attention.attend))
    if impl == "torch":
        monkeypatch.setattr(attention, "_attend_torch",
                            counted("plain", attention._attend_torch))
        monkeypatch.setattr(marks, "vjp_of", counted("vjp", marks.vjp_of))
    else:
        monkeypatch.setattr(flash_mod, "attention_reference",
                            counted("plain", flash_mod.attention_reference))
        monkeypatch.setattr(attention, "flash_attention_vjp",
                            counted("vjp", attention.flash_attention_vjp))
    runs = {}
    for label, policy, names in (
            ("keep", "keep", ("blk_in",)), ("remat", "remat", ("blk_in",)),
            ("blk_in", "offload", ("blk_in",)),
            ("offload", "offload", ("attn_out",)),
            ("save_names", "save_names", ("attn_out",))):
        calls.update(attend=0, plain=0, vjp=0)
        runs[label] = _run(cfg, policy, names, steps_=1, impl=impl)
        runs[label]["calls"] = dict(calls)
    L = cfg.num_layers
    assert runs["keep"]["calls"] == {"attend": L, "plain": L, "vjp": 0}
    for label in ("remat", "blk_in"):
        assert runs[label]["calls"] == {"attend": 2 * L, "plain": 2 * L,
                                        "vjp": 0}
    for label in ("offload", "save_names"):
        assert runs[label]["calls"] == {"attend": L, "plain": 2 * L,
                                        "vjp": L}
        _bitwise(runs[label], runs["keep"])


# ------------------------------------------- (f) the op counter on meta

def _count(names, dev, policy="offload", impl="torch"):
    api = build_model(resolve_config("small-gpt"))
    settings = dataclasses.replace(
        steps.build_settings(api.cfg, None, None, kind="train",
                             activation_policy=policy, attn_impl=impl,
                             device=dev), offload_names=names)
    bundle = steps.make_train_step(api, None, None, sgd(),
                                   ShapeConfig("t", 64, 2, "train"),
                                   settings=settings, device=dev)
    with OpCounter(dev) as c:
        c.track(bundle.args)
        bundle.fn(*bundle.args)
    bundle.close()
    return api.cfg, c.analysis()


@pytest.mark.parametrize("names", [ATTN_MLP, ("blk_in",) + ATTN_MLP])
def test_a_meta_step_counts_the_named_bytes_as_host_bytes(names):
    cfg, meta = _count(names, "meta")
    _, cpu = _count(names, "cpu")
    es = 2                                   # small-gpt is bf16
    tokens = 2 * 64
    per_layer = tokens * (cfg.num_heads * cfg.resolved_head_dim + cfg.d_ff
                          + cfg.d_model * ("blk_in" in names)) * es
    assert meta.host_bytes == cpu.host_bytes == cfg.num_layers * per_layer
    assert meta.flops == cpu.flops
    _, saved = _count(names, "meta", policy="save_names")
    assert saved.host_bytes == 0 and saved.flops == meta.flops
    # through the kernel the dry run counts one flash call a layer, as
    # keep does (the held output's backward is the kernel's, the plain
    # VJP), where the host tier of "blk_in" alone counts two
    _, held = _count(names, "meta", impl="cuda")
    _, blk = _count(("blk_in",), "meta", impl="cuda")
    assert held.kernels["flash_attention"]["calls"] == cfg.num_layers
    assert blk.kernels["flash_attention"]["calls"] == 2 * cfg.num_layers
    assert held.flops < blk.flops


# ------------------------------------------------------------ (g) a mesh

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_worker(rank, port, d):
    import torch.distributed as dist
    from repro_torch.parallel.comm import init_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        mesh = init_mesh((1, 2), ("data", "model"), device="cpu")
        cfg = _port_cfg("gpt")
        out = {}
        for policy in ("keep", "offload"):
            with TrainSession(cfg, engine="jit", device="cpu", batch_size=B,
                              seq_len=S, seed=SEED, mesh=mesh,
                              optimizer=topt.adamw(LR, clip_norm=None),
                              settings=_settings(policy, ATTN_MLP)) as s:
                res = s.run(2)
                out[policy] = {
                    "losses": res.losses,
                    "params": [t.detach().clone()
                               for t in tree_flatten(s.params)[0]],
                    "named": [r.extra.get("named_bytes")
                              for r in res.reports],
                    "policy": repr(s.engine.policy),
                    "leased": s.engine.spool.pool._leased_bytes}
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_a_tensor_mesh_offload_is_bitwise_its_keep(tmp_path):
    d = str(tmp_path)
    mp.start_processes(_mesh_worker, args=(_free_port(), d), nprocs=2,
                       start_method="spawn")
    cfg = _port_cfg("gpt")
    # a rank's share: half the heads and half the d_ff columns
    share = cfg.num_layers * B * S * (
        cfg.num_heads * cfg.resolved_head_dim + cfg.d_ff) * 4 // 2
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("error")
        _bitwise(res["offload"], res["keep"])
        assert res["offload"]["named"] == [share, share]
        assert "HostTierPolicy" in res["offload"]["policy"]
        assert res["offload"]["leased"] == 0

