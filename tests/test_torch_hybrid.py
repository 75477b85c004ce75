"""The hybrid family (recurrentgemma: RG-LRU blocks and local attention,
each with a gated GELU MLP, embeddings scaled by sqrt(d_model)) through
the port against the JAX package and against itself.

  * The config, its segments (12 x (rglru, rglru, attn) and a remainder
    of (rglru, rglru)) and the init tree against JAX's.
  * The gated MLP and the embedding scale against JAX's.
  * `reduced(recurrentgemma-9b, layers=5)` (both segments, an attention
    block, S=32 > window 16), float32: loss and every gradient against
    `build_model(cfg).loss` at the bars of test_torch_models.py
    (loss 1e-5, grads rtol 1e-4 / atol 1e-5), through the plain
    recurrence and through the kernel wrappers (plain on the CPU).
  * The staged engine against the JAX `StagedTrainer`, sgd, 3 steps
    (the bars of test_torch_train.py); Keep / Spool / Recompute bitwise
    equal over the two-segment, multi-block stage chain; no W x W tensor
    among an rglru stage's spooled tensors.
  * TrainSession and the CLI take the full config with sgd.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.recurrentgemma_9b import CONFIG as JAX_RG  # noqa: E402
from repro.core.staged import StagedTrainer  # noqa: E402
from repro.models import api as japi_mod  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import ModelConfig, SpoolIoConfig  # noqa: E402
from repro_torch.configs import resolve_config  # noqa: E402
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.ids import storage_ptr  # noqa: E402
from repro_torch.core.policies import (KeepPolicy,  # noqa: E402
                                       RecomputePolicy, SpoolPolicy)
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import api as api_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import (RunSettings,  # noqa: E402
                                            build_segments)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402

B, S = 2, 32
MIN_OFF = 2 ** 8


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(reduced(JAX_RG, layers=5), dtype=dtype, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _batches(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _flatten(tree, path=()):
    """(key path, leaf) pairs of nested dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _flat(params):
    return [t.detach() for t in tree_flatten(params)[0]]


def _settings(impl="torch"):
    return RunSettings(attn_impl=impl, attn_chunk=8, param_dtype="float32",
                       device="cpu")


def test_config_matches_jax():
    got = resolve_config("recurrentgemma-9b")
    assert dataclasses.asdict(got) == dataclasses.asdict(JAX_RG)


@pytest.mark.parametrize("layers_", [38, 5, 6])
def test_build_segments_match_jax(layers_):
    """12 x (rglru, rglru, attn window 2048) + (rglru, rglru) x 1 for the
    full config; the reduced cuts keep the same pattern."""
    jcfg = JAX_RG if layers_ == 38 else reduced(JAX_RG, layers=layers_)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    want = [([(b.mixer, b.window, b.mlp) for b in s.blocks], s.n_repeat)
            for s in jtr.build_segments(jcfg)]
    got = [([(b.mixer, b.window, b.mlp) for b in s.blocks], s.n_repeat)
           for s in build_segments(tcfg)]
    assert got == want
    if layers_ == 38:
        assert got == [([("rglru", 0, "dense"), ("rglru", 0, "dense"),
                         ("attn", 2048, "dense")], 12),
                       ([("rglru", 0, "dense"), ("rglru", 0, "dense")], 1)]


def test_init_tree_matches_jax():
    """Same key paths, shapes and dtypes as the JAX init in bf16: the
    gated MLP's w_gate, the f32 rglru leaves, separate embed / unembed
    tables (the JAX package does not tie them)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.eval_shape(jax_build(jcfg).init, jax.random.key(0))
    tp = build_model(tcfg).init(torch.Generator().manual_seed(0))
    want = dict(_flatten(jp))
    got = dict(_flatten(tp))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    assert "w_gate" in tp["segments"][0]["b0"]["mlp"]
    assert tp["segments"][1]["b1"]["rglru"]["b_a"].dtype == torch.float32


def test_gated_mlp_matches_jax():
    """act(x @ w_gate) * (x @ w_in) @ w_out with the exact GELU: forward
    and every grad at 1e-5."""
    rng = np.random.default_rng(1)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in (
        ("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    g = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jf = lambda p, x: (jlayers.apply_mlp(p, x, "gelu", True)  # noqa: E731
                       * jnp.asarray(g)).sum()
    jy = jlayers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           "gelu", True)
    jgp, jgx = jax.grad(jf, (0, 1))(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = layers.apply_mlp(tp, tx, "gelu", glu=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    keys = sorted(tp)
    got = torch.autograd.grad(ty, [tp[k] for k in keys] + [tx],
                              torch.from_numpy(g))
    for k, a in zip(keys, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(jgp[k]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_embed_matches_jax(dtype):
    """Embeddings times sqrt(d_model) rounded to the parameter dtype, bit
    for bit (d_model 48: sqrt is not exact in bf16)."""
    jcfg, tcfg = _cfgs(dtype, d_model=48, rglru_width=48)
    jp = jax_build(jcfg).init(jax.random.key(2))
    toks = np.random.default_rng(3).integers(0, 512, (B, S)).astype(
        np.int32)
    want = japi_mod._embed_in(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                              JaxSettings(param_dtype=dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = api_mod.embed_in(tp, {"tokens": torch.from_numpy(toks).long()},
                           tcfg)
    assert got.dtype == tp["embed"].dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    assert not torch.equal(got, tp["embed"][torch.from_numpy(toks).long()])


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """The JAX package's loss and grads of the reduced hybrid, f32, on a
    batch with masked labels (the Pallas RG-LRU kernel in interpret
    mode; its xla path is the same function)."""
    jcfg, tcfg = _cfgs()
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.key(3))
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size,
                                              (2, S + 1)).astype(np.int32)
    toks[1, -5:] = -1
    batch = {"tokens": toks[:, :-1].clip(0), "labels": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        JaxSettings(attn_impl="pallas_interpret", attn_chunk=8,
                    param_dtype="float32"))
    return tcfg, jparams, batch, float(jl), jg


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_loss_and_grads_match_jax(jax_loss_and_grads, impl):
    tcfg, jparams, batch, jl, jg = jax_loss_and_grads
    api = build_model(tcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tl, metrics = api.loss(params, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()},
                           _settings(impl))
    assert int(metrics["tokens"]) == 2 * S - 5
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    got = torch.autograd.grad(tl, leaves)
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    for a, b in zip(got, tree_flatten(want)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _port_run(tcfg, jparams, policy, *, steps=3, io=None, impl="cuda"):
    api = build_model(tcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    opt = topt.sgd(1e-2)
    eng = StagedEngine(api, _settings(impl), opt, policy=policy,
                       io_config=io or SpoolIoConfig(backend="mem"),
                       min_offload_elements=MIN_OFF)
    state = opt.init(params)
    reps = []
    try:
        for b in _batches(tcfg.vocab_size, steps):
            params, state, rep = eng.train_step(params, state, [b])
            reps.append(rep)
    finally:
        eng.close()
    return [r.loss for r in reps], params, reps, eng


@pytest.fixture(scope="module")
def keep_run():
    jcfg, tcfg = _cfgs()
    jparams = jax_build(jcfg).init(jax.random.key(0))
    losses, params, reps, eng = _port_run(tcfg, jparams, KeepPolicy())
    return jcfg, tcfg, jparams, losses, params, eng


def test_engine_matches_jax_staged_trainer(keep_run):
    """Port engine (kernel wrappers) vs the JAX StagedTrainer (Pallas
    RG-LRU in interpret mode), sgd, 3 steps on the same batches."""
    jcfg, tcfg, jparams, losses, params, eng = keep_run
    assert eng.stage_names == ["embed", "seg0_l0", "seg1_l0", "head"]
    opt = jopt.sgd(1e-2)
    tr = StagedTrainer(jax_build(jcfg), JaxSettings(
        attn_impl="pallas_interpret", attn_chunk=8, param_dtype="float32"),
        opt, strategy="keep", min_offload_elements=MIN_OFF)
    p, st, jl = jparams, opt.init(jparams), []
    try:
        for b in _batches(tcfg.vocab_size):
            p, st, rep = tr.train_step(
                p, st, [{k: jnp.asarray(v) for k, v in b.items()}])
            jl.append(rep.loss)
    finally:
        tr.close()
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    assert len(_flat(want)) == len(_flat(params))
    for got, w in zip(_flat(params), _flat(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("policy", [SpoolPolicy, RecomputePolicy])
def test_policies_bitwise_equal_to_keep(keep_run, policy):
    """Spool (every stage stored and fetched) and Recompute give the keep
    run's losses and params bit for bit over the two-segment chain."""
    _, tcfg, jparams, losses, params, _ = keep_run
    got, p, reps, eng = _port_run(tcfg, jparams, policy())
    assert got == losses
    for a, b in zip(_flat(p), _flat(params)):
        assert torch.equal(a, b)
    n = len(eng.stage_names)
    if policy is SpoolPolicy:
        assert all(r.extra["stages_offloaded"] == n
                   == r.extra["stages_fetched"] for r in reps)
        assert all(r.stats.bytes_offloaded > 0 for r in reps)
    else:
        assert reps[0].extra["stages_recomputed"] == n - 2


@pytest.mark.parametrize("policy", [KeepPolicy, SpoolPolicy])
def test_each_stage_frees_its_tensors_at_its_backward(policy, monkeypatch):
    """With the cyclic garbage collector off, every stage's kept or
    spooled tensors are gone once its backward is done (checked as the
    next stage's backward ends): a fetched tree must not sit in a
    reference cycle, or every stage's activations stay on the card until
    the collector runs."""
    import gc
    import weakref

    from repro_torch.core.spool import ActivationSpool
    _, tcfg = _cfgs()
    refs = {}
    for name in ("keep", "offload"):
        real = getattr(ActivationSpool, name)

        def spy(self, key, tree, real=real):
            real(self, key, tree)
            refs[key] = [weakref.ref(t) for t in tree]

        monkeypatch.setattr(ActivationSpool, name, spy)
    real_add = StagedEngine._add_grads
    seen = []

    def add(self, grads, params, stage, p_stage, got):
        done = self.stage_names.index(stage.name)
        alive = [k for k, v in refs.items() if int(k.split("_s")[1]) > done
                 and any(r() is not None for r in v)]
        seen.append((stage.name, alive))
        real_add(self, grads, params, stage, p_stage, got)

    monkeypatch.setattr(StagedEngine, "_add_grads", add)
    api = build_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0))
    opt = topt.sgd(1e-2)
    eng = StagedEngine(api, _settings("cuda"), opt, policy=policy(),
                       io_config=SpoolIoConfig(backend="mem"),
                       min_offload_elements=1)
    enabled = gc.isenabled()
    gc.disable()
    try:
        eng.train_step(params, opt.init(params),
                       _batches(tcfg.vocab_size, 1))
    finally:
        if enabled:
            gc.enable()
        eng.close()
    assert [n for n, _ in seen] == eng.stage_names[::-1]
    assert all(r for r in refs.values())
    assert seen == [(n, []) for n, _ in seen]


def test_rglru_stages_spool_no_w_by_w_tensor(monkeypatch):
    """bf16 hybrid: the f32 products with w_a and w_i save the bf16
    weight (a parameter), not its f32 copy, so no spooled tensor of any
    stage has a W x W shape, and no spooled leaf lies in a parameter's
    storage."""
    from repro_torch.core.spool import ActivationSpool
    _, tcfg = _cfgs("bfloat16", rglru_width=40)
    W = tcfg.rglru_width
    real = ActivationSpool.offload
    leaves = []

    def spy(self, key, tree):
        real(self, key, tree)
        leaves.extend(tree[i] for i in self._records[key]["spool_idx"])

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    api = build_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0))
    pstores = {storage_ptr(t) for t in _flat(params)}
    opt = topt.sgd(1e-2)
    eng = StagedEngine(api, RunSettings(attn_impl="cuda", attn_chunk=8,
                                        param_dtype="bfloat16",
                                        device="cpu"), opt,
                       policy=SpoolPolicy(),
                       io_config=SpoolIoConfig(backend="mem"),
                       min_offload_elements=1)
    try:
        eng.train_step(params, opt.init(params),
                       _batches(tcfg.vocab_size, 1))
    finally:
        eng.close()
    assert leaves
    assert all(tuple(t.shape[-2:]) != (W, W) for t in leaves)
    assert all(storage_ptr(t) not in pstores for t in leaves)


def test_session_and_cli_take_the_full_config_with_sgd():
    """The full recurrentgemma-9b builds (no weights are drawn) into the
    15-stage chain, with sgd, through TrainSession and the CLI."""
    with TrainSession("recurrentgemma-9b", optimizer="sgd", device="cpu",
                      batch_size=1, seq_len=2048) as s:
        names = s.engine.stage_names
        assert s.optimizer.name == "sgd"
    assert names == (["embed"] + [f"seg0_l{i}" for i in range(12)]
                     + ["seg1_l0", "head"])
    args = train_cli.parse_args(["--arch", "recurrentgemma-9b",
                                 "--optimizer", "sgd", "--steps", "3",
                                 "--batch", "1", "--seq", "2048",
                                 "--strategy", "spool"])
    assert (args.arch, args.optimizer, args.strategy) == (
        "recurrentgemma-9b", "sgd", "spool")
