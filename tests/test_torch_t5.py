"""The paper's T5 (encoder-decoder: a bidirectional encoder, then decoder
layers of causal self-attention and cross-attention over the encoder
states; learned positions, no RoPE) in the port, against the JAX package
on one set of weights (JAX `init` -> numpy -> `params_from_jax`) and
numpy-seeded batches, in float32 on the CPU:

  * `t5` and `small_t5` are the JAX configs field for field; `init`
    makes the JAX tree (`enc_segments`, `enc_norm`, the decoder's `b0`
    without an MLP and its `b1`, cross with one);
  * one cross block on both dispatch paths, with the encoder longer than
    the decoder, at 2e-5;
  * logits, the loss at 1e-5 and every gradient at rtol 2e-4 / atol 2e-5
    (the shared `embed` and `pos_embed` tables and the encoder's leaves
    among them), with an encoder input of its own length;
  * the staged engine's sgd steps against the JAX `StagedTrainer`, with
    the same stage list, at one and at two microbatches;
  * keep, spool (fs and mem), recompute and adaptive through
    `TrainSession(loader=...)`, bitwise equal, every stored stage
    fetched; no stored tensor of a cross stage lies in the encoder
    states' storage; a failed load in a cross stage falls back to
    recompute, bitwise equal to keep;
  * T5 has no decode step in the port yet: prefill and decode refuse.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_models as jpm  # noqa: E402
from repro.core.staged import StagedTrainer  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import BlockDef as JaxBlockDef  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro.models.transformer import apply_block as jax_apply_block  # noqa
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import (PAPER_SCENARIOS, SpoolIoConfig,  # noqa
                                 small_t5, t5)
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.ids import storage_ptr  # noqa: E402
from repro_torch.core.policies import (AdaptivePolicy,  # noqa: E402
                                       KeepPolicy, RecomputePolicy,
                                       SpoolPolicy)
from repro_torch.core.spool import (SpoolLoadError,  # noqa: E402
                                    SpoolStepTransaction)
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import (BlockDef,  # noqa: E402
                                            RunSettings, apply_block)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402

B, S, SE = 2, 32, 40          # the encoder input is longer than the decoder's
F32 = dict(dtype="float32")
STAGES = ["enc_embed", "enc0_l0", "enc0_l1", "enc_final", "embed",
          "seg0_l0", "seg0_l1", "head"]


def _cfgs(hidden=128, layers=4):
    return (dataclasses.replace(jpm.small_t5(hidden, layers), **F32),
            dataclasses.replace(small_t5(hidden, layers), **F32))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = jax_build(jcfg).init(jax.random.key(7))
    return jcfg, tcfg, jparams


def _params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _batch(vocab, seed=0, enc_len=SE, mask_tail=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if mask_tail:
        labels[1, -mask_tail:] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            "enc_tokens": rng.integers(0, vocab, (B, enc_len)).astype(
                np.int32)}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _jset():
    return JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")


def _tset(impl="torch"):
    return RunSettings(attn_impl=impl, attn_chunk=8, param_dtype="float32",
                       device="cpu")


def test_configs_match_jax():
    pairs = [(jpm.small_t5(), small_t5()), (jpm.small_t5(384, 3),
                                            small_t5(384, 3))]
    pairs += [(jpm.t5(h, l), t5(h, l)) for h, l in PAPER_SCENARIOS]
    for want, got in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    big = t5(8192, 4)
    assert (big.family, big.num_layers, big.num_decoder_layers, big.causal,
            big.use_rope, big.mlp_glu, big.padded_vocab) == (
                "encdec", 2, 2, True, False, True, 32256)
    with pytest.raises(ValueError, match="num_decoder_layers"):
        build_model(small_t5(128, 1))


def test_init_makes_the_jax_tree(weights):
    jcfg, tcfg, jparams = weights
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))

    def spec(tree, shape):
        if isinstance(tree, dict):
            return {k: spec(v, shape) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [spec(v, shape) for v in tree]
        return (shape(tree), str(tree.dtype).replace("torch.", ""))

    want = spec(jparams, lambda a: tuple(a.shape))
    got = spec(params, lambda t: tuple(t.shape))
    assert got == want
    dec = params["segments"][0]
    assert set(dec) == {"b0", "b1"} and "mlp" not in dec["b0"]
    assert set(dec["b1"]) == {"norm", "attn", "mlp", "mlp_norm"}
    assert len(params["enc_segments"]) == 1
    assert params["enc_segments"][0]["b0"]["attn"]["wq"].shape[0] == 2
    assert params["enc_norm"]["scale"].shape == (jcfg.d_model,)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_cross_block_matches_jax(weights, impl):
    """One cross block, Sq=16 against Skv=24 encoder states (on CPU
    tensors "cuda" runs the kernel's plain reference)."""
    jcfg, tcfg, jparams = weights
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][0]["b1"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 16, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, 24, jcfg.d_model)).astype(np.float32)
    want, (wk, wv) = jax_apply_block(
        JaxBlockDef("cross", mlp="dense"), jp, jnp.asarray(x), jcfg,
        _jset(), enc_kv=jnp.asarray(enc), aux={})
    tp = _params(jax.tree.map(np.asarray, jp))
    with torch.inference_mode():
        got, (gk, gv) = apply_block(
            BlockDef("cross", mlp="dense"), tp, torch.from_numpy(x), tcfg,
            _tset(impl), enc_kv=torch.from_numpy(enc))
    assert gk.shape == (B, 24, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


def test_forward_logits_match_jax(weights):
    jcfg, tcfg, jparams = weights
    b = _batch(tcfg.vocab_size, 3)
    b.pop("labels")
    want, _ = jax_build(jcfg).forward(jparams, _jax_batch(b), _jset())
    with torch.inference_mode():
        got = build_model(tcfg).forward(_params(jparams), _torch_batch(b),
                                        _tset())
    V = tcfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(),
                               np.asarray(want)[..., :V], rtol=1e-5,
                               atol=1e-5)


def test_loss_and_grads_match_jax(weights):
    """f32 loss at rtol 1e-5 and every gradient leaf at rtol 2e-4 / atol
    2e-5; the shared tables get the encoder's and the decoder's parts."""
    jcfg, tcfg, jparams = weights
    batch = _batch(tcfg.vocab_size, 4, mask_tail=5)
    (jl, _), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jparams, _jax_batch(batch), _jset())
    params = _params(jparams)
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tl, metrics = build_model(tcfg).loss(params, _torch_batch(batch),
                                         _tset())
    assert int(metrics["tokens"]) == B * S - 5
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = torch.autograd.grad(tl, leaves)
    want = tree_flatten(_params(jg))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    grads = dict(zip(map(id, leaves), got))
    for t in (params["embed"], params["pos_embed"],
              params["enc_segments"][0]["b0"]["attn"]["wk"],
              params["enc_norm"]["scale"]):
        assert float(grads[id(t)].abs().max()) > 0
    # the positions past the encoder's length get no gradient
    assert float(grads[id(params["pos_embed"])][SE:].abs().max()) == 0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_engine_matches_jax_staged_trainer(weights, microbatches):
    """Three sgd steps through the port's staged engine and the JAX
    StagedTrainer on the same batches, the same stage list: the bars of
    test_torch_train.py::test_engine_matches_jax_staged_trainer."""
    jcfg, tcfg, jparams = weights
    steps = [[_batch(tcfg.vocab_size, 10 + 2 * i + m)
              for m in range(microbatches)] for i in range(3)]
    opt = topt.sgd(1e-2)
    eng = StagedEngine(build_model(tcfg), _tset(), opt,
                       policy=KeepPolicy(),
                       io_config=SpoolIoConfig(backend="mem"))
    params = _params(jparams)
    state, losses = opt.init(params), []
    try:
        for mbs in steps:
            params, state, rep = eng.train_step(params, state, mbs)
            losses.append(rep.loss)
    finally:
        eng.close()
    jo = jopt.sgd(1e-2)
    tr = StagedTrainer(jax_build(jcfg), _jset(), jo, strategy="keep")
    p, st, jl = jparams, jo.init(jparams), []
    try:
        assert eng.stage_names == [s.name for s in tr._stages] == STAGES
        for mbs in steps:
            p, st, rep = tr.train_step(p, st, [_jax_batch(b) for b in mbs])
            jl.append(rep.loss)
    finally:
        tr.close()
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)
    for got, w in zip(tree_flatten(params)[0], tree_flatten(_params(p))[0]):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-5)


def _loader(vocab, seed):
    """An endless stream of T5 batches whose encoder input is its own."""
    i = 0
    while True:
        yield _batch(vocab, seed + i)
        i += 1


def _session_run(tcfg, jparams, policy, io=None, steps=3):
    with TrainSession(tcfg, policy=policy, io=io, optimizer="sgd", lr=1e-2,
                      device="cpu", loader=_loader(tcfg.vocab_size, 20),
                      min_offload_elements=1024) as sess:
        sess.params = _params(jparams)
        sess.opt_state = sess.optimizer.init(sess.params)
        res = sess.run(steps)
        return (res.losses, [t.detach() for t in tree_flatten(res.params)[0]],
                res.reports, sess.engine)


@pytest.fixture(scope="module")
def keep_session(weights):
    _, tcfg, jparams = weights
    return _session_run(tcfg, jparams, KeepPolicy())


def _bitwise(params, keep_session):
    assert len(params) == len(keep_session[1])
    assert all(torch.equal(a, b) for a, b in zip(params, keep_session[1]))


@pytest.mark.parametrize("how", ["spool-fs", "spool-mem", "recompute",
                                 "adaptive"])
def test_policies_bitwise_equal_through_the_session(weights, keep_session,
                                                    how, tmp_path):
    _, tcfg, jparams = weights
    io = None
    if how == "recompute":
        policy = RecomputePolicy()
    elif how == "adaptive":
        policy = AdaptivePolicy()
    else:
        backend = how.split("-")[1]
        policy, io = SpoolPolicy(), SpoolIoConfig(
            backend=backend,
            directory=str(tmp_path) if backend == "fs" else None)
    losses, params, reps, eng = _session_run(tcfg, jparams, policy, io)
    assert losses == keep_session[0]
    _bitwise(params, keep_session)
    assert eng.stage_names == STAGES
    ex = [r.extra for r in reps]
    if how == "recompute":
        layers = tcfg.num_layers + tcfg.num_decoder_layers
        assert layers == 4
        assert all(e["stages_recomputed"] == layers for e in ex)
        assert all(e["stages_kept"] == len(STAGES) - layers for e in ex)
    else:
        assert all(e["stages_offloaded"] + e["stages_kept"]
                   == e["stages_fetched"] == len(STAGES) for e in ex)
        assert sum(r.stats.bytes_offloaded + r.stats.bytes_forwarded
                   for r in reps) > 0
        if how == "adaptive":
            assert eng.plan is not None and not eng.plan.offload[-1]
        else:
            assert all(e["stages_offloaded"] == len(STAGES) for e in ex)
    if how == "spool-fs":
        assert list(tmp_path.iterdir()) == []


def test_no_stored_tensor_of_a_cross_stage_is_the_encoder_states(
        weights, monkeypatch):
    """The pack hook sees the encoder states (the cross block's K/V
    projections save them) and stores none of their storage: the engine
    holds `enc` as a graph leaf through the whole decoder."""
    _, tcfg, jparams = weights
    real_hooks = StagedEngine._hooks
    calls = []                         # (enc storage or None, packed it)

    def hooks(self, saved, cell, x_in=None, enc=None):
        pack, unpack = real_hooks(self, saved, cell, x_in, enc)
        rec = [None if enc is None else storage_ptr(enc), False]
        calls.append(rec)

        def spy(t):
            if rec[0] is not None and storage_ptr(t) == rec[0]:
                rec[1] = True
            return pack(t)
        return spy, unpack

    real_offload = SpoolStepTransaction.offload
    stored = []

    def offload(self, stage, tree):
        stored.append((stage, [storage_ptr(t) for t in tree]))
        return real_offload(self, stage, tree)

    monkeypatch.setattr(StagedEngine, "_hooks", hooks)
    monkeypatch.setattr(SpoolStepTransaction, "offload", offload)
    _, _, _, eng = _session_run(tcfg, jparams, SpoolPolicy(), steps=1)
    assert len(calls) == len(stored) == len(STAGES)
    cross = [i for i, st in enumerate(eng._stages) if st.takes_enc]
    assert [STAGES[i] for i in cross] == ["seg0_l0", "seg0_l1"]
    for (enc_ptr, packed), (stage, ptrs) in zip(calls, stored):
        if stage in cross:
            assert packed and ptrs and enc_ptr not in ptrs, stage


def test_failed_fetch_in_a_cross_stage_falls_back_to_recompute(
        weights, keep_session, monkeypatch):
    _, tcfg, jparams = weights
    cross = STAGES.index("seg0_l1")
    real = SpoolStepTransaction.fetch
    failed = []

    def flaky(self, stage):
        if stage == cross and not failed:
            failed.append(stage)
            raise SpoolLoadError("injected: blob lost")
        return real(self, stage)

    monkeypatch.setattr(SpoolStepTransaction, "fetch", flaky)
    losses, params, _, eng = _session_run(tcfg, jparams, SpoolPolicy())
    assert failed == [cross] and eng.spool.stats.fetch_fallbacks == 1
    assert losses == keep_session[0]
    _bitwise(params, keep_session)


def test_decode_and_prefill_refuse(weights):
    _, tcfg, jparams = weights
    api, params = build_model(tcfg), _params(jparams)
    b = _torch_batch(_batch(tcfg.vocab_size))
    with pytest.raises(NotImplementedError, match="cross"):
        api.prefill(params, b, _tset())
    with pytest.raises(NotImplementedError, match="cross"):
        api.decode_step(params, [], {"tokens": b["tokens"][:, :1]}, 0,
                        _tset())
    with pytest.raises(NotImplementedError, match="cross"):
        api.decode_step_paged(params, [], [], None,
                              {"tokens": b["tokens"][:, :1]}, [0, 0],
                              _tset())
