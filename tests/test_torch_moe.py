"""The port's MoE (`repro_torch/models/moe.py`, llama4-scout and kimi-k2
at JAX's `reduced(...)`) against the JAX package's local dropless path.

  * `_route`: expert ids equal (no top-k tie in the f32 router
    probabilities, asserted, so the two packages' tie rules never
    decide), weights and aux terms at 1e-6; `_expert_ranks` exactly;
    `apply_moe` at 1e-5.
  * The forward's aux terms summed over layers (the model's loss with
    them, its gradients and decode steps are in
    `tests/test_torch_archs.py`).
  * The engine under each name follows the JAX engine of that name: the
    staged engine against the JAX `StagedTrainer` (no aux terms), the
    jit engine against a JAX jit session (aux in the loss and in the
    metric rows).
  * Inside the port: keep = spool bitwise under both names, the
    dispatch adds into no buffer (no `index_add_` / `scatter_add_`), a
    mesh whose expert axis does not divide the experts is refused (the
    mesh paths are in `tests/test_torch_mesh_moe.py`), and the exact
    residual counter runs the MoE layer
    on the meta device and equals the engine's layer bytes.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.staged import StagedTrainer  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro.optim import optimizers as jopt  # noqa: E402
from repro.session import TrainSession as JSession  # noqa: E402
from repro.session.session import resolve_config as jax_resolve  # noqa
from repro_torch.configs import SpoolIoConfig, resolve_config  # noqa: E402
from repro_torch.core.endurance import residual_bytes_per_layer  # noqa
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.policies import KeepPolicy, SpoolPolicy  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
B, S, SEED, LR = 2, 16, 3, 1e-2
TSET = RunSettings(attn_impl="torch", attn_chunk=8, param_dtype="float32",
                   device="cpu")


def _cfgs(arch):
    return (dataclasses.replace(jax_resolve(arch + ":reduced"),
                                dtype="float32"),
            dataclasses.replace(resolve_config(arch + ":reduced"),
                                dtype="float32"))


def _jset():
    return JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")


def _moe_settings(cfg):
    return (jmoe.MoESettings(cfg.moe_num_experts, cfg.moe_top_k,
                             act=cfg.act),
            moe.MoESettings(cfg.moe_num_experts, cfg.moe_top_k,
                            act=cfg.act))


def _perturbed(japi, seed=0):
    """JAX init weights as numpy, all-zero leaves (norm scales) noised."""
    leaves, tdef = jax.tree_util.tree_flatten(japi.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 7)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return tdef.unflatten(out)


def _moe_params(arch, seed=0):
    """(cfg, one MoE layer's params as numpy) from the JAX init."""
    jcfg, _ = _cfgs(arch)
    w = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(seed)))
    seg = w["segments"][-1]["b0"]["moe"]
    return jcfg, {k: v[0] for k, v in seg.items()}


def _assert_no_topk_tie(probs, k):
    """The k-th and (k+1)-th largest probabilities differ in every row,
    and so do the k largest: the selection and its order are unique."""
    srt = np.sort(probs, axis=-1)[:, ::-1]
    assert (np.diff(srt[:, :min(k + 1, srt.shape[1])], axis=-1) < 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg, p = _moe_params(arch)
    js, ts = _moe_settings(cfg)
    x = np.random.default_rng(1).standard_normal((B * S, cfg.d_model)
                                                 ).astype(np.float32)
    je, jw, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), js)
    te, tw, taux = moe._route(torch.from_numpy(x),
                              torch.from_numpy(p["router"].copy()), ts)
    logits = x @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    _assert_no_topk_tie(probs / probs.sum(-1, keepdims=True), cfg.moe_top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,E", [(48, 4), (7, 3), (64, 16), (1, 2)])
def test_expert_ranks_match_jax_exactly(n, E):
    eids = np.random.default_rng(n).integers(0, E, n).astype(np.int32)
    want = np.asarray(jmoe._expert_ranks(jnp.asarray(eids), E))
    got = moe._expert_ranks(torch.from_numpy(eids).long(), E)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch):
    cfg, p = _moe_params(arch)
    js, ts = _moe_settings(cfg)
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    jy, jaux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), js)
    ty, taux = moe.apply_moe({k: torch.from_numpy(v.copy())
                              for k, v in p.items()},
                             torch.from_numpy(x), ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-6)


def test_dispatch_adds_into_no_buffer_and_refuses_a_mesh(monkeypatch):
    """Each (expert, rank) slot is written once: the layer's forward and
    backward call neither `index_add_` nor `scatter_add_` from Python
    (the autograd of its `index_select` adds into zeros at the unique
    slot indices, one addend each)."""
    cfg, p = _moe_params("kimi-k2-1t-a32b")
    _, ts = _moe_settings(cfg)

    def refuse(*a, **k):
        raise AssertionError("an add-into-buffer dispatch")

    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in p.items()}
    x = torch.randn((B, S, cfg.d_model), requires_grad=True)
    for name in ("index_add_", "scatter_add_", "index_add",
                 "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y, aux = moe.apply_moe(params, x, ts)
    (y.square().sum() + aux["moe_lb"]).backward()
    monkeypatch.undo()
    assert x.grad is not None and params["w_in"].grad.abs().sum() > 0
    # a mesh whose expert axis does not divide the experts
    from repro_torch.parallel.mesh import make_test_mesh
    with pytest.raises(ValueError, match="do not split"):
        moe.apply_moe(params, x, ts, mesh=make_test_mesh((1, 3)),
                      ep_axis="model")


@pytest.mark.parametrize("cap", [0.5, 8.0])
def test_dropped_rows_counts_what_the_capacity_drops(cap):
    """`moe.dropped_rows` adds, per forward, the assignments ranked at or
    past the capacity C: over the experts, max(0, rows routed - C)."""
    from repro_torch.parallel.mesh import make_test_mesh
    cfg, p = _moe_params("llama4-scout-17b-a16e")
    _, ts = _moe_settings(cfg)
    ts = dataclasses.replace(ts, capacity_factor=cap)
    params = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    E, k = ts.num_experts, ts.top_k
    C = int(np.ceil(B * S * k / E * cap))
    eids, _, _ = moe._route(x.reshape(-1, cfg.d_model), params["router"], ts)
    counts = np.bincount(eids.numpy().reshape(-1), minlength=E)
    want = int(np.maximum(counts - C, 0).sum())
    moe.dropped_rows.reset()
    moe.apply_moe(params, x, ts, mesh=make_test_mesh((1, 1)),
                  ep_axis="model")
    assert moe.dropped_rows.read() == want
    assert (want > 0) == (cap < 1.0)
    moe.apply_moe(params, x, ts)                  # dropless: adds 0
    assert moe.dropped_rows.read() == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_sums_aux_over_layers_as_jax(arch):
    """`forward(..., with_aux=True)`: the logits and each aux term summed
    over the MoE layers, as JAX's `forward` returns them."""
    jcfg, tcfg = _cfgs(arch)
    japi, api = jax_build(jcfg), build_model(tcfg)
    w = _perturbed(japi, 3)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (B, S))
    jl, jaux = japi.forward(jax.tree.map(jnp.asarray, w),
                            {"tokens": jnp.asarray(toks, jnp.int32)},
                            _jset())
    with torch.inference_mode():
        tl, taux = api.forward(params_from_jax(w, device="cpu"),
                               {"tokens": torch.from_numpy(toks)}, TSET,
                               with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert sorted(taux) == sorted(jaux) == ["moe_lb", "moe_z"]
    for k in taux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-5)


def _batches(vocab, n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _engine_run(tcfg, w, policy, *, name="staged", io=None, steps=2,
                attn_chunk=8):
    api = build_model(tcfg)
    params = params_from_jax(w, device="cpu")
    opt = topt.sgd(LR)
    settings = dataclasses.replace(TSET, activation_policy="keep",
                                   attn_chunk=attn_chunk)
    eng = StagedEngine(api, settings, opt, policy=policy,
                       io_config=io or SpoolIoConfig(backend="mem"),
                       min_offload_elements=0, engine_name=name)
    state, reps = opt.init(params), []
    try:
        for b in _batches(tcfg.vocab_size, steps):
            params, state, rep = eng.train_step(params, state, [b])
            reps.append(rep)
    finally:
        eng.close()
    return reps, params


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_engine_matches_jax_staged_trainer_without_aux(arch):
    jcfg, tcfg = _cfgs(arch)
    japi = jax_build(jcfg)
    w = _perturbed(japi, 1)
    reps, params = _engine_run(tcfg, w, KeepPolicy())
    opt = jopt.sgd(LR)
    tr = StagedTrainer(japi, _jset(), opt, strategy="keep",
                       min_offload_elements=0)
    p = jax.tree.map(jnp.asarray, w)
    st, jl = opt.init(p), []
    try:
        for b in _batches(tcfg.vocab_size):
            p, st, rep = tr.train_step(
                p, st, [{k: jnp.asarray(v) for k, v in b.items()}])
            jl.append(rep.loss)
    finally:
        tr.close()
    np.testing.assert_allclose([r.loss for r in reps], jl, rtol=1e-5)
    assert "moe_lb" not in reps[0].extra
    want = tree_flatten(params_from_jax(jax.tree.map(np.asarray, p),
                                        device="cpu"))[0]
    for got, wt in zip(tree_flatten(params)[0], want):
        np.testing.assert_allclose(got.numpy(), wt.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_jit_session_matches_jax_jit_session_with_aux(arch):
    jcfg, tcfg = _cfgs(arch)
    common = dict(engine="jit", batch_size=B, seq_len=S, seed=SEED, lr=LR,
                  min_offload_elements=0)
    jsess = JSession(jcfg, optimizer=jopt.sgd(LR), ckpt_every=0, **common)
    try:
        jres = jsess.run(2)
        jrows = [r.to_metrics() for r in jres.reports]
        jparams = jax.tree.leaves(jsess.state.params)
    finally:
        jsess.close()
    with TrainSession(tcfg, device="cpu", optimizer=topt.sgd(LR),
                      **common) as s:
        s.params = params_from_jax(jax.tree.map(
            np.asarray, jax_build(jcfg).init(jax.random.key(SEED))),
            device="cpu")
        s.opt_state = s.optimizer.init(s.params)
        res = s.run(2)
        rows = [r.to_metrics() for r in res.reports]
        params = tree_flatten(s.params)[0]
    for row, jrow in zip(rows, jrows):
        for k in ("loss", "ce", "moe_lb", "moe_z"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-5,
                                       err_msg=k)
        assert row["loss"] > row["ce"]
        assert row["tokens"] == jrow["tokens"]
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("name", ["staged", "jit"])
def test_keep_equals_spool_bitwise(name):
    """kimi (a dense segment, then MoE) kept and spooled, under each
    engine name: losses and parameters bitwise; under "jit" the loss
    carries the aux terms the staged name drops."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    w = _perturbed(jax_build(jcfg), 2)
    rk, pk = _engine_run(tcfg, w, KeepPolicy(), name=name)
    rs, ps = _engine_run(tcfg, w, SpoolPolicy(), name=name)
    assert [r.loss for r in rk] == [r.loss for r in rs]
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(pk)[0],
                                                  tree_flatten(ps)[0]))
    assert all(r.stats.bytes_offloaded + r.stats.bytes_forwarded > 0
               for r in rs)
    if name == "jit":
        assert all(r.loss > r.extra["ce"] and r.extra["moe_lb"] > 0
                   for r in rk)
        assert [r.extra["moe_z"] for r in rk] == [r.extra["moe_z"]
                                                  for r in rs]
    else:
        assert "ce" not in rk[0].extra


def test_residual_counter_runs_moe_on_meta():
    _, tcfg = _cfgs("llama4-scout-17b-a16e")
    jcfg, _ = _cfgs("llama4-scout-17b-a16e")
    # the counter's settings: the plain attention in chunks of 256
    reps, _ = _engine_run(tcfg, _perturbed(jax_build(jcfg)), SpoolPolicy(),
                          steps=1, attn_chunk=256)
    per = residual_bytes_per_layer(tcfg, B, S, offloadable_only=False,
                                   attn_impl="torch")
    assert reps[0].extra["layer_saved_bytes"] == tcfg.num_layers * per > 0
