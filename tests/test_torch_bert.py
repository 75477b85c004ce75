"""The paper's BERT (encoder-only: bidirectional attention, learned
positions, no RoPE) in the port, against the JAX package on one set of
weights (JAX `init` -> numpy -> `params_from_jax`) and numpy-seeded
batches, in float32 on the CPU:

  * `bert`, `small_bert` and `resolve_config("small-bert")` are the JAX
    configs field for field; `init` makes `pos_embed` of the JAX shape;
  * the embedding with learned positions, bidirectional attention on
    both dispatch paths, and forward logits at 1e-5;
  * the training loss at 1e-5 and every gradient at 1e-4, and the
    staged engine's sgd steps against the JAX `StagedTrainer`;
  * keep, spool (fs and mem) and recompute through `TrainSession`,
    bitwise equal, every stored stage fetched;
  * `launch.train --arch small-bert --device cpu` trains 2 steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_models as jpm  # noqa: E402
from repro.core.staged import StagedTrainer  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.api import _embed_in as jax_embed_in  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import (SpoolIoConfig, bert,  # noqa: E402
                                 resolve_config, small_bert)
from repro_torch.core.policies import (KeepPolicy,  # noqa: E402
                                       RecomputePolicy, SpoolPolicy)
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.api import build_model, embed_in  # noqa: E402
from repro_torch.models.attention import attend  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.session import TrainSession  # noqa: E402

B, S = 2, 32
F32 = dict(dtype="float32")


def _cfgs(hidden=128, layers=2):
    return (dataclasses.replace(jpm.small_bert(hidden, layers), **F32),
            dataclasses.replace(small_bert(hidden, layers), **F32))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = jax_build(jcfg).init(jax.random.key(5))
    return jcfg, tcfg, jparams


def _params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _batch(vocab, seed=0, mask_tail=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if mask_tail:
        labels[1, -mask_tail:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jset():
    return JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")


def _tset():
    return RunSettings(attn_impl="torch", attn_chunk=8,
                       param_dtype="float32", device="cpu")


def test_configs_match_jax():
    for want, got in ((jpm.small_bert(), small_bert()),
                      (jpm.small_bert(), resolve_config("small-bert")),
                      (jpm.small_bert(384, 3), small_bert(384, 3)),
                      (jpm.bert(8192, 4), bert(8192, 4)),
                      (jpm.bert(16384, 2), bert(16384, 2))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    big = bert(12288, 3)
    assert (big.causal, big.use_rope, big.num_heads, big.resolved_head_dim,
            big.padded_vocab, big.has_decode) == (False, False, 96, 128,
                                                  30720, False)
    # no bert-h<H>-l<L> string: the JAX package has none either
    with pytest.raises(ValueError, match="unknown arch"):
        resolve_config("bert-h8192-l4")


def test_init_makes_the_jax_tree(weights):
    jcfg, tcfg, jparams = weights
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert params["pos_embed"].shape == (jcfg.max_position, jcfg.d_model)
    flat_w, _ = jax.tree.flatten(want, is_leaf=lambda x: isinstance(
        x, tuple) and len(x) == 2 and isinstance(x[1], str))
    flat_g = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for t in tree_flatten(params)[0]]
    assert flat_g == flat_w


def test_embedding_with_learned_positions_matches_jax(weights):
    jcfg, tcfg, jparams = weights
    toks = _batch(tcfg.vocab_size, 1)["tokens"]
    want = jax_embed_in(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                        _jset())
    got = embed_in(_params(jparams), {"tokens": torch.from_numpy(toks)},
                   tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_bidirectional_attention_matches_jax(impl):
    """Both dispatch paths with causal=False over several KV chunks (on
    CPU tensors "cuda" runs the kernel's plain reference)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, chunk=16, impl="xla")
    got = attend(*(torch.from_numpy(a) for a in (q, k, v)), causal=False,
                 chunk=16, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_logits_match_jax(weights):
    jcfg, tcfg, jparams = weights
    toks = _batch(tcfg.vocab_size, 3)["tokens"]
    want, _ = jax_build(jcfg).forward(jparams, {"tokens": jnp.asarray(toks)},
                                      _jset())
    with torch.inference_mode():
        got = build_model(tcfg).forward(_params(jparams),
                                        {"tokens": torch.from_numpy(toks)},
                                        _tset())
    V = tcfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(),
                               np.asarray(want)[..., :V], rtol=1e-5,
                               atol=1e-5)


def test_loss_and_grads_match_jax(weights):
    """f32 loss at 1e-5 and every gradient leaf (pos_embed included) at
    1e-4: the bars of test_torch_models.py::test_loss_and_grads_match_jax."""
    jcfg, tcfg, jparams = weights
    batch = _batch(tcfg.vocab_size, 4, mask_tail=5)
    (jl, _), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, _jset())
    params = _params(jparams)
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tl, metrics = build_model(tcfg).loss(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        _tset())
    assert int(metrics["tokens"]) == B * S - 5
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = torch.autograd.grad(tl, leaves)
    want = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jg),
                                        device="cpu"))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    i = next(i for i, t in enumerate(leaves) if t is params["pos_embed"])
    assert float(got[i].abs().max()) > 0       # the learned positions train


def test_engine_matches_jax_staged_trainer(weights):
    """Three sgd steps through the port's staged engine (embed, one stage
    per layer, head) and the JAX StagedTrainer on the same batches: the
    bars of test_torch_train.py::test_engine_matches_jax_staged_trainer."""
    jcfg, tcfg, jparams = weights
    batches = [_batch(tcfg.vocab_size, 10 + i) for i in range(3)]
    opt = topt.sgd(1e-2)
    eng = StagedEngine(build_model(tcfg), _tset(), opt,
                       policy=KeepPolicy(),
                       io_config=SpoolIoConfig(backend="mem"))
    params = _params(jparams)
    state, losses = opt.init(params), []
    try:
        assert eng.stage_names == ["embed", "seg0_l0", "seg0_l1", "head"]
        for b in batches:
            params, state, rep = eng.train_step(params, state, [b])
            losses.append(rep.loss)
    finally:
        eng.close()
    jo = jopt.sgd(1e-2)
    tr = StagedTrainer(jax_build(jcfg), _jset(), jo, strategy="keep")
    p, st, jl = jparams, jo.init(jparams), []
    try:
        for b in batches:
            p, st, rep = tr.train_step(
                p, st, [{k: jnp.asarray(v) for k, v in b.items()}])
            jl.append(rep.loss)
    finally:
        tr.close()
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)
    for got, w in zip(tree_flatten(params)[0], tree_flatten(_params(p))[0]):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-5)


def _session_run(tcfg, jparams, policy, io=None):
    with TrainSession(tcfg, policy=policy, io=io, optimizer="sgd", lr=1e-2,
                      batch_size=B, seq_len=S, device="cpu",
                      min_offload_elements=1024) as sess:
        sess.params = _params(jparams)
        sess.opt_state = sess.optimizer.init(sess.params)
        res = sess.run(2)
        return (res.losses, [t.detach() for t in tree_flatten(res.params)[0]],
                res.reports, len(sess.engine.stage_names))


@pytest.fixture(scope="module")
def keep_session(weights):
    _, tcfg, jparams = weights
    return _session_run(tcfg, jparams, KeepPolicy())


@pytest.mark.parametrize("how", ["spool-fs", "spool-mem", "recompute"])
def test_policies_bitwise_equal_through_the_session(weights, keep_session,
                                                    how, tmp_path):
    _, tcfg, jparams = weights
    if how == "recompute":
        policy, io = RecomputePolicy(), None
    else:
        backend = how.split("-")[1]
        policy, io = SpoolPolicy(), SpoolIoConfig(
            backend=backend,
            directory=str(tmp_path) if backend == "fs" else None)
    losses, params, reps, n_stages = _session_run(tcfg, jparams, policy, io)
    assert losses == keep_session[0]
    assert all(torch.equal(a, b) for a, b in zip(params, keep_session[1]))
    if how == "recompute":
        assert all(r.extra["stages_recomputed"] == tcfg.num_layers
                   for r in reps)
    else:
        assert n_stages == tcfg.num_layers + 2
        assert all(r.extra["stages_offloaded"] == r.extra["stages_fetched"]
                   == n_stages for r in reps)
        assert sum(r.stats.bytes_offloaded + r.stats.bytes_forwarded
                   for r in reps) > 0
    if how == "spool-fs":
        assert list(tmp_path.iterdir()) == []


def test_cli_trains_small_bert_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "small-bert", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "32", "--strategy",
                    "spool", "--min-offload", "4096", "--spool-dir",
                    str(tmp_path / "spool")])
    out = capsys.readouterr().out
    assert "arch=bert-h256-l4" in out and "step    2 loss" in out
    assert "flash_attention launches 0" in out
    assert list((tmp_path / "spool").iterdir()) == []
