"""The port's jit engine (`TrainSession(engine="jit")`, `launch/steps.py`,
`core/policies.py::policy_for_jit` / `JitOffloadPlan`) against the port's
staged engine and against the JAX package's jit engine.

  * Bitwise across the mapped engines: jit with
    `host_offload="activations"` equals staged with SpoolPolicy (GPT, and
    T5 for its encoder stream), with the overlap too; a
    `spool_stages` mask spools exactly the marked decoder layers; a plan
    profiled by the staged AdaptivePolicy drives the jit engine
    (`plan_for_jit`) to the same losses, and it is the JAX package's plan
    for the same profiles; microbatches scale the tapped gradients as
    the fused update scales them.
  * Across the packages, on the JAX init's weights (`params_from_jax`):
    a port jit session against a JAX jit session, serial with the state
    staged through the spool, clip-free adamw and sgd-momentum (the JAX
    eager bridge is no oracle for sgd-momentum: it fails its own bitwise
    test), losses rtol 1e-5, parameters rtol 2e-4 / atol 1e-4; a
    checkpoint of a port overlap session restores in a JAX session and a
    JAX one in a port overlap session; the metric rows' keys match key
    for key.
  * The refusals the JAX session makes, the mapping of the tiers' names
    and the one name they refuse, and the CLI on the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.base import SpoolIoConfig as JIo  # noqa: E402
from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.core.adaptive import ModuleProfile as JProfile  # noqa: E402
from repro.core.policies import AdaptivePolicy as JAdaptive  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.session import TrainSession as JSession  # noqa: E402
from repro_torch.configs import SpoolIoConfig, small_t5  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core.adaptive import ModuleProfile  # noqa: E402
from repro_torch.core.engine import ENC_STAGE_BASE  # noqa: E402
from repro_torch.core.policies import (AdaptivePolicy,  # noqa: E402
                                       LayerSpoolPolicy, policy_for_jit)
from repro_torch.core.spool import ActivationSpool  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.data.pipeline import encoder_decoder_batches  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TCFG = dataclasses.replace(small_gpt(128, 2), dtype="float32")
JCFG = dataclasses.replace(jax_small_gpt(128, 2), dtype="float32")
T5 = dataclasses.replace(small_t5(128, 4), dtype="float32")
B, S, SEED, LR = 2, 32, 3, 1e-3
MIN_OFF = 2 ** 8
STEPS = 3


def _flat(tree):
    return [t.detach().cpu().clone() for t in tree_flatten(tree)[0]]


def _session(cfg=TCFG, *, engine="jit", optimizer=None, **kw):
    loader = (encoder_decoder_batches(cfg.vocab_size, batch=B, seq_len=S,
                                      seed=SEED)
              if cfg.family == "encdec" else None)
    return TrainSession(cfg, engine=engine, device="cpu", batch_size=B,
                        seq_len=S, seed=SEED, loader=loader,
                        optimizer=optimizer or topt.adamw(
                            LR, clip_norm=None),
                        min_offload_elements=MIN_OFF, **kw)


def _train(steps=STEPS, **kw):
    with _session(**kw) as s:
        res = s.run(steps)
        bridge = s.opt_bridge
        opt = bridge.materialize() if bridge is not None else s.opt_state
        return {"losses": res.losses, "params": _flat(s.params),
                "mu": _flat(opt.mu), "reports": res.reports,
                "layout": sorted(bridge._layout) if bridge else None}


def _bitwise(a, b):
    assert a["losses"] == b["losses"], (a["losses"], b["losses"])
    for k in ("params", "mu"):
        assert len(a[k]) == len(b[k])
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k


# ------------------------------------------- across the mapped engines

@pytest.mark.parametrize("cfg", [TCFG, T5], ids=["gpt", "t5"])
def test_jit_activations_equal_staged_spool(cfg):
    io = SpoolIoConfig(backend="mem", host_offload="activations")
    staged = _train(cfg=cfg, engine="staged", policy="spool",
                    io=SpoolIoConfig(backend="mem"))
    jit = _train(cfg=cfg, io=io)
    _bitwise(staged, jit)
    assert all(r.stats.bytes_offloaded + r.stats.bytes_forwarded > 0
               for r in jit["reports"])
    # and with the overlap on: the encoder layers tap from ENC_STAGE_BASE
    over = _train(cfg=cfg, io=io, opt_overlap=True)
    _bitwise(staged, over)
    n_dec = cfg.num_decoder_layers if cfg.family == "encdec" \
        else cfg.num_layers
    want = list(range(n_dec))
    if cfg.family == "encdec":
        want += [ENC_STAGE_BASE + i for i in range(cfg.num_layers)]
    assert over["layout"] == sorted(want)


def test_spool_stages_mask_spools_only_the_marked_layers(monkeypatch):
    stored = []
    real = ActivationSpool.offload

    def spy(self, key, tree):
        stored.append(key)
        return real(self, key, tree)

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    settings = RunSettings(attn_impl="torch", attn_chunk=256,
                           param_dtype="float32", device="cpu",
                           activation_policy="spool",
                           spool_stages=(False, True))
    io = SpoolIoConfig(backend="mem", host_offload="activations")
    with _session(io=io, settings=settings) as s:
        s.run(1)
        names = s.engine.stage_names
    assert [names[int(k.split("_s")[1])] for k in stored] == ["seg0_l1"]
    assert [LayerSpoolPolicy((True,), ["seg0_l0", "seg0_l1"])
            .should_offload(0, ModuleProfile(n, 0, 0.0))
            for n in ("embed", "seg0_l0", "seg0_l1", "enc0_l0", "head")] \
        == [False, True, True, True, False]


def test_plan_for_jit_drives_both_engines():
    policy = AdaptivePolicy()
    staged = _train(engine="staged", policy=policy,
                    io=SpoolIoConfig(backend="mem"))
    plan = policy.plan_for_jit()
    assert len(plan.spool_stages) == TCFG.num_layers
    base = RunSettings(attn_impl="torch", attn_chunk=256,
                       param_dtype="float32", device="cpu")
    mode = "activations" if plan.activation_policy == "spool" else "none"
    jit = _train(io=SpoolIoConfig(backend="mem", host_offload=mode),
                 settings=plan.apply(base))
    _bitwise(staged, jit)
    # the JAX package's translation of the same profile is the same plan
    jpol = JAdaptive()
    jpol.on_profile([JProfile(p.name, p.bytes, p.fwd_time)
                     for p in policy.profiles], policy.bandwidths)
    jplan = jpol.plan_for_jit()
    assert (plan.spool_stages, plan.activation_policy) == (
        jplan.spool_stages, jplan.activation_policy)
    with pytest.raises(RuntimeError, match="profiling step"):
        AdaptivePolicy().plan_for_jit()


def test_microbatches_scale_the_tapped_gradients():
    plain = _train(microbatches=2)
    over = _train(microbatches=2, opt_overlap=True,
                  io=SpoolIoConfig(backend="mem"))
    _bitwise(plain, over)


def test_refusals():
    with pytest.raises(ValueError, match="plan_for_jit"):
        _session(policy="spool")
    with pytest.raises(ValueError, match="activation_policy='spool'"):
        _session(io=SpoolIoConfig(backend="mem",
                                  host_offload="activations"),
                 settings=RunSettings(device="cpu",
                                      activation_policy="keep"))
    # the tiers take the names the layers mark (a layer's input and the
    # names inside it, tests/test_torch_named_tiers.py); a fifth name is
    # refused, where JAX ignores it
    for tier in ("offload", "offload_ssd", "save_names"):
        for name in ("attn_out", "mlp_hidden", "moe_hidden"):
            pol = policy_for_jit(RunSettings(activation_policy=tier,
                                             offload_names=(name,)))
            assert pol.inner_names == (name,) and not pol.host_inputs
            assert pol.inner_on_host == (tier != "save_names")
            assert pol.recomputes("layer") and not pol.recomputes("head")
        with pytest.raises(ValueError, match="the layers mark"):
            policy_for_jit(RunSettings(activation_policy=tier,
                                       offload_names=("attn_in",)))
    with pytest.raises(ValueError, match="unknown engine"):
        _session(engine="xla")
    with pytest.raises(ValueError, match="device"):
        _session(settings=RunSettings(device="cuda"))


# ------------------------------------------------- across the packages

def _jax_init(seed=SEED):
    from repro.models.api import build_model
    return build_model(JCFG).init(jax.random.key(seed))


def _jax_session(**kw):
    return JSession(JCFG, engine="jit", batch_size=B, seq_len=S, seed=SEED,
                    lr=LR, min_offload_elements=MIN_OFF, **kw)


def _on_jax_weights(sess):
    sess.params = params_from_jax(jax.tree.map(np.asarray, _jax_init()),
                                  device="cpu")
    sess.opt_state = sess.optimizer.init(sess.params)


@pytest.mark.parametrize("name,make_t,make_j", [
    ("adamw", lambda: topt.adamw(LR, clip_norm=None),
     lambda: jopt.adamw(LR, clip_norm=None)),
    ("sgd-momentum", lambda: topt.sgd(LR, momentum=0.9),
     lambda: jopt.sgd(LR, momentum=0.9)),
])
def test_serial_jit_session_matches_jax(tmp_path, name, make_t, make_j):
    jsess = _jax_session(io=JIo(backend="mem", host_offload="opt_state"),
                         optimizer=make_j(), ckpt_dir=str(tmp_path / "j"),
                         ckpt_every=0)
    try:
        jres = jsess.run(STEPS)
        jparams = jax.tree.leaves(jsess.state.params)
    finally:
        jsess.close()
    with _session(io=SpoolIoConfig(backend="mem", host_offload="opt_state"),
                  optimizer=make_t()) as s:
        _on_jax_weights(s)
        res = s.run(STEPS)
        params = _flat(s.params)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)


def test_metric_rows_match_jax_key_for_key(tmp_path):
    """An overlap session, traced, with its spool: every key of a JAX jit
    session's rows and no other."""
    common = dict(trace_ring=4096)
    jsess = _jax_session(io=JIo(backend="mem"), opt_overlap=True,
                         optimizer=jopt.adamw(LR, clip_norm=None),
                         ckpt_dir=str(tmp_path / "j"), ckpt_every=0,
                         **common)
    try:
        jres = jsess.run(2)
        jrows = [r.to_metrics() for r in jres.reports]
    finally:
        jsess.close()
    with _session(io=SpoolIoConfig(backend="mem"), opt_overlap=True,
                  **common) as s:
        _on_jax_weights(s)
        res = s.run(2)
        rows = [r.to_metrics() for r in res.reports]
    for row, jrow in zip(rows, jrows):
        assert sorted(row) == sorted(jrow)
        for k in ("opt_updates", "opt_fetched_bytes", "opt_staged_bytes",
                  "tokens", "step"):
            assert row[k] == jrow[k], k
    np.testing.assert_allclose([r["loss"] for r in rows],
                               [r["loss"] for r in jrows], rtol=1e-5)


def _jax_state_arrays(state):
    return ([np.asarray(x) for x in jax.tree.leaves(state.params)],
            [np.asarray(x) for x in jax.tree.leaves(state.opt_state.mu)],
            [np.asarray(x) for x in jax.tree.leaves(state.opt_state.nu)],
            int(state.opt_state.step))


def _assert_states_equal(port, jax_arrays):
    params, mu, nu, step = jax_arrays
    assert port[3] == step
    for got, want in zip(port[:3], (params, mu, nu)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), b)


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A port overlap session's checkpoint (its moments materialized from
    the spool) restores in a JAX jit session, and a JAX overlap
    session's in a port overlap session, bitwise; both go on training
    alike."""
    opt = dict(optimizer=jopt.adamw(LR, clip_norm=None))
    # the port writes, the JAX package reads
    pdir = str(tmp_path / "port")
    with _session(io=SpoolIoConfig(backend="mem"), opt_overlap=True,
                  ckpt_dir=pdir, ckpt_every=0) as s:
        _on_jax_weights(s)
        s.run(2)
        st = s.opt_bridge.materialize()
        port_state = (_flat(s.params), _flat(st.mu), _flat(st.nu), st.step)
        port_next = s.run(1).losses
    jsess = _jax_session(io=JIo(backend="mem"), ckpt_dir=pdir,
                         ckpt_every=0, **opt)
    try:
        # the step-2 checkpoint: drop the port's step-3 one first
        import shutil
        shutil.rmtree(os.path.join(pdir, "step_00000003"))
        jsess.run(0, resume=True)
        _assert_states_equal(port_state, _jax_state_arrays(jsess.state))
        jnext = jsess.run(1).losses
    finally:
        jsess.close()
    np.testing.assert_allclose(jnext, port_next, rtol=1e-5)
    # the JAX package writes, the port reads
    jdir = str(tmp_path / "jax")
    jsess = _jax_session(io=JIo(backend="mem"), opt_overlap=True,
                         ckpt_dir=jdir, ckpt_every=0, **opt)
    try:
        jsess.run(2)
        jstate = _jax_state_arrays(jsess.state)
        jnext = jsess.run(1).losses
    finally:
        jsess.close()
    shutil.rmtree(os.path.join(jdir, "step_00000003"))
    with _session(io=SpoolIoConfig(backend="mem"), opt_overlap=True,
                  ckpt_dir=jdir, ckpt_every=0) as s:
        s.run(0, resume=True)
        assert s.step == 2 and s.opt_bridge.seeded
        st = s.opt_bridge.materialize()
        _assert_states_equal((_flat(s.params), _flat(st.mu), _flat(st.nu),
                              st.step), jstate)
        np.testing.assert_allclose(s.run(1).losses, jnext, rtol=1e-5)
        with pytest.raises(RuntimeError, match="fresh session"):
            s.run(1, resume=True)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("flags,want", [
    (["--opt-overlap", "--clip-norm", "0"], "opt-overlap: 8 per-layer"),
    (["--host-offload", "opt_state"], "done: 2 steps"),
    (["--host-offload", "activations"], "done: 2 steps"),
])
def test_cli_trains_the_jit_engine_on_cpu(tmp_path, capsys, flags, want):
    train_cli.main(["--arch", "small-gpt", "--device", "cpu", "--engine",
                    "jit", "--steps", "2", "--batch", "2", "--seq", "32",
                    "--min-offload", "4096", "--spool-dir",
                    str(tmp_path / "spool")] + flags)
    out = capsys.readouterr().out
    assert "step    2 loss" in out and want in out
    assert list((tmp_path / "spool").iterdir()) == []
