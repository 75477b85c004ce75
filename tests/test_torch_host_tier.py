"""The host-memory activation tier: the JAX jit engine's
`activation_policy` "offload" / "offload_ssd" (a layer's input, "blk_in",
in pinned host memory between its forward and its backward, the layer
recomputed) and "save_names" (the named tensors kept on the device), in
the port's one engine (`core/policies.py::HostTierPolicy`,
`core/engine.py::_HostTier`), on the CPU in float32:

  * `policy_for_jit` maps "offload" and "offload_ssd" to the host tier
    and "save_names" of "blk_in" to RecomputePolicy; the names inside a
    layer ("attn_out", "mlp_hidden", "moe_hidden") map to the host tier's
    and SaveNamesPolicy's inner names (their runs are in
    `tests/test_torch_named_tiers.py`), and a name no layer marks is
    refused;
  * on small-gpt and llama-3.2-vision at `:reduced`, "offload" and
    "offload_ssd" are bitwise equal to "keep" (losses and final
    parameters), "save_names" to "remat";
  * the tracked activation footprint at backward begin under the tier
    is remat's minus every layer stage's input, and its peak lower; the
    inputs' device storages are freed while they lie on the host, every
    pool lease comes back, and no spool record, byte or file is made;
  * the jit name under "offload" against a JAX jit session under
    "offload" on the JAX init's weights, at
    test_torch_jit.py::test_serial_jit_session_matches_jax's bars.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SpoolIoConfig, resolve_config
from repro_torch.configs.paper_models import small_gpt
from repro_torch.core.engine import StagedEngine, _HostTier
from repro_torch.core.policies import (JIT_ACTIVATION_POLICIES,
                                       OFFLOAD_NAMES, HostTierPolicy,
                                       RecomputePolicy, SaveNamesPolicy,
                                       policy_for_jit)
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import vision_batches
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.optim import optimizers as topt
from repro_torch.session import TrainSession
from torch_one_thread import one_torch_thread  # noqa: E402,F401

B, S, SEED, LR = 2, 32, 3, 1e-3
GPT = dataclasses.replace(small_gpt(128, 3), dtype="float32")
VISION = dataclasses.replace(resolve_config("llama-3.2-vision-90b:reduced"),
                             dtype="float32", num_layers=4)
CFGS = {"gpt": GPT, "vision": VISION}


def _settings(policy, **kw):
    return RunSettings(attn_impl="torch", attn_chunk=256,
                       param_dtype="float32", device="cpu",
                       activation_policy=policy, **kw)


def _loader(cfg):
    if cfg.family != "vlm":
        return None
    return vision_batches(cfg.vocab_size, cfg.d_model, cfg.encoder_seq_len,
                          batch=B, seq_len=S, seed=SEED)


def _run(cfg, policy, steps=2, params=None):
    with TrainSession(cfg, engine="jit", device="cpu", batch_size=B,
                      seq_len=S, seed=SEED, loader=_loader(cfg),
                      optimizer=topt.adamw(LR, clip_norm=None),
                      settings=_settings(policy)) as s:
        if params is not None:
            s.params = params
            s.opt_state = s.optimizer.init(s.params)
        res = s.run(steps)
        eng = s.engine
        out = {"losses": res.losses, "reports": res.reports,
               "params": [t.detach().clone()
                          for t in tree_flatten(s.params)[0]],
               "spool": s.spool, "stats": eng.spool.stats,
               "written": eng.spool.backend.stats.bytes_written,
               "policy": eng.policy}
    return out


def _bitwise(a, b):
    assert a["losses"] == b["losses"], (a["losses"], b["losses"])
    assert len(a["params"]) == len(b["params"])
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))


def test_policy_for_jit_maps_the_tiers():
    assert JIT_ACTIVATION_POLICIES == ("keep", "remat", "offload",
                                       "offload_ssd", "save_names", "spool")
    for tier in ("offload", "offload_ssd"):
        pol = policy_for_jit(RunSettings(activation_policy=tier))
        assert isinstance(pol, HostTierPolicy) and pol.host_inputs
        assert pol.recomputes("layer") and not pol.recomputes("head")
        assert not pol.should_offload(0)
    pol = policy_for_jit(RunSettings(activation_policy="save_names"))
    assert type(pol) is RecomputePolicy and not pol.host_inputs
    # no name: nothing moved or saved, which is remat
    pol = policy_for_jit(RunSettings(activation_policy="offload",
                                     offload_names=()))
    assert type(pol) is RecomputePolicy
    for name in ("attn_out", "mlp_hidden", "moe_hidden"):
        names = ("blk_in", name)
        for tier in ("offload", "offload_ssd"):
            pol = policy_for_jit(RunSettings(activation_policy=tier,
                                             offload_names=names))
            assert isinstance(pol, HostTierPolicy) and pol.host_inputs
            assert pol.inner_names == (name,) and pol.inner_on_host
        pol = policy_for_jit(RunSettings(activation_policy="save_names",
                                         offload_names=names))
        assert type(pol) is SaveNamesPolicy and not pol.host_inputs
        assert pol.inner_names == (name,) and not pol.inner_on_host
    pol = policy_for_jit(RunSettings(
        activation_policy="offload", offload_names=OFFLOAD_NAMES))
    assert pol.host_inputs and pol.inner_names == OFFLOAD_NAMES[1:]
    for tier in ("offload", "save_names"):
        with pytest.raises(ValueError, match="the layers mark"):
            policy_for_jit(RunSettings(activation_policy=tier,
                                       offload_names=("blk_in", "mlp")))
    with pytest.raises(ValueError, match="unknown activation_policy"):
        policy_for_jit(RunSettings(activation_policy="pinned"))


@pytest.fixture(scope="module", params=sorted(CFGS))
def runs(request):
    cfg = CFGS[request.param]
    return cfg, {p: _run(cfg, p) for p in ("keep", "remat", "offload",
                                           "offload_ssd", "save_names")}


def test_tiers_are_bitwise(runs):
    cfg, r = runs
    _bitwise(r["keep"], r["offload"])
    _bitwise(r["keep"], r["offload_ssd"])
    _bitwise(r["remat"], r["save_names"])
    _bitwise(r["keep"], r["remat"])
    assert all(np.isfinite(r["keep"]["losses"]))
    assert isinstance(r["offload"]["policy"], HostTierPolicy)


def test_the_tier_moves_the_stage_inputs_and_nothing_else(runs):
    """Backward begins with every layer stage's input off the device
    (B x S x D elements each); the peak holds at most two of them; no
    spool is made and nothing is stored or written."""
    cfg, r = runs
    layers = cfg.num_layers // (cfg.cross_attn_period or 1)
    one = B * S * cfg.d_model * 4
    for tier, remat in zip(r["offload"]["reports"], r["remat"]["reports"]):
        assert tier.backward_begin_bytes == \
            remat.backward_begin_bytes - layers * one
        assert tier.peak_activation_bytes <= \
            remat.peak_activation_bytes - (layers - 2) * one
        assert tier.peak_activation_bytes < remat.peak_activation_bytes
    for p in ("offload", "offload_ssd"):
        assert r[p]["spool"] is None
        st = r[p]["stats"]
        assert st.bytes_offloaded == st.bytes_loaded == \
            st.bytes_forwarded == 0
        assert r[p]["written"] == 0


def test_inputs_lie_on_the_host_between_forward_and_backward(monkeypatch):
    """The engine under HostTierPolicy: each layer stage's input is
    freed on the device after its forward (its storage shrunk to 0
    bytes) and back, bitwise, before its recompute; every pool lease is
    released at the step's end."""
    cfg = VISION
    api = build_model(cfg)
    eng = StagedEngine(api, _settings("offload"), topt.sgd(LR),
                       policy=HostTierPolicy(),
                       io_config=SpoolIoConfig(backend="mem"))
    seen = []
    real_offload, real_restore = _HostTier.offload, _HostTier.restore

    def offload(self, si, t, key):
        before = t.detach().clone()
        real_offload(self, si, t, key)
        seen.append([si, t, before, t.untyped_storage().nbytes()])

    def restore(self, si):
        real_restore(self, si)
        for rec in seen:
            if rec[0] == si:
                rec.append(torch.equal(rec[1].detach(), rec[2]))

    monkeypatch.setattr(_HostTier, "offload", offload)
    monkeypatch.setattr(_HostTier, "restore", restore)
    params = api.init(torch.Generator().manual_seed(0))
    state = eng.optimizer.init(params)
    batch = next(_loader(cfg))
    try:
        _, _, rep = eng.train_step(params, state, [batch])
        assert eng.stage_names == ["vlm_enc", "embed", "seg0_l0", "seg0_l1",
                                   "head"]
        assert rep.extra["stages_host"] == rep.extra["stages_recomputed"] \
            == 2
        assert [r[0] for r in seen] == [2, 3]
        assert all(r[3] == 0 and r[4] for r in seen)
        pool = eng.spool.pool
        assert pool.stats()["peak_leased_bytes"] > 0
        assert pool._leased_bytes == 0
        assert eng.spool.live_keys() == []
    finally:
        eng.close()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_offload_matches_a_jax_offload_session(name):
    jax = pytest.importorskip("jax")
    from repro.configs.paper_models import small_gpt as jax_small_gpt
    from repro.models.api import build_model as jax_build
    from repro.models.transformer import RunSettings as JaxSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession
    from repro.session.session import resolve_config as jax_resolve
    from repro_torch.models.convert import params_from_jax
    cfg = CFGS[name]
    jcfg = (dataclasses.replace(jax_small_gpt(128, 3), dtype="float32")
            if name == "gpt" else dataclasses.replace(
                jax_resolve("llama-3.2-vision-90b:reduced"),
                dtype="float32", num_layers=4))
    jsess = JSession(jcfg, engine="jit", batch_size=B, seq_len=S, seed=SEED,
                     lr=LR, optimizer=jopt.adamw(LR, clip_norm=None),
                     loader=_loader(cfg), settings=JaxSettings(
                         attn_impl="xla", attn_chunk=256,
                         param_dtype="float32", activation_policy="offload"))
    try:
        jres = jsess.run(2)
        jparams = [np.asarray(x) for x in jax.tree.leaves(jsess.state.params)]
    finally:
        jsess.close()
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_build(jcfg).init(jax.random.key(SEED))),
        device="cpu")
    got = _run(cfg, "offload", params=params)
    np.testing.assert_allclose(got["losses"], jres.losses, rtol=1e-5)
    assert len(got["params"]) == len(jparams)
    for a, b in zip(got["params"], jparams):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-4)
