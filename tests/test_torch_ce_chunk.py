"""Chunked cross-entropy (`RunSettings.ce_chunk`) in the port: the model's
`loss` against the JAX package's chunked `api.loss`, and the staged
engine's head stage, which runs it and saves no logits. float32
small-gpt on the CPU, weights from the JAX init.

  * `api.loss` with `ce_chunk` (S=64 in chunks of 16, some labels
    masked, with and without a final-logit softcap): loss and every
    gradient at 2e-4 against JAX's; the same loss as the unchunked one
    at 2e-4; no chunking when the chunk does not divide S.
  * The engine with `ce_chunk`: keep, spool and recompute bitwise equal,
    losses at 2e-4 of the unchunked engine's; the head stage hands the
    spool only the labels (its input, the hidden state, is held as a
    graph leaf, its parameters are excluded), where the unchunked head
    stores the (B, S, V) f32 logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.policies import (KeepPolicy,  # noqa: E402
                                       RecomputePolicy, SpoolPolicy)
from repro_torch.core.spool import ActivationSpool  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = 2e-4
B, S, CHUNK = 2, 64, 16


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jax_small_gpt(128, 2), **kw),
            dataclasses.replace(small_gpt(128, 2), **kw))


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1                  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _settings(chunk):
    return RunSettings(attn_impl="torch", attn_chunk=64,
                       param_dtype="float32", device="cpu", ce_chunk=chunk)


@pytest.fixture(scope="module")
def jax_model():
    """JAX init of the two configs' weights (no softcap, softcap 30)."""
    out = {}
    for cap in (0.0, 30.0):
        jcfg, tcfg = _cfgs(final_logit_softcap=cap)
        jparams = jax.jit(jax_build(jcfg).init)(jax.random.key(0))
        out[cap] = (jcfg, tcfg, jax.tree.map(np.asarray, jparams))
    return out


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_loss_and_grads_match_jax(jax_model, cap):
    jcfg, tcfg, np_params = jax_model[cap]
    batch = _batch(tcfg.vocab_size)
    japi = jax_build(jcfg)
    jset = JaxSettings(attn_impl="xla", attn_chunk=64,
                       param_dtype="float32", ce_chunk=CHUNK)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {k: jnp.asarray(v) for k, v in
                                batch.items()}, jset), has_aux=True))(
        np_params)
    api = build_model(tcfg)
    params = params_from_jax(np_params, device="cpu")
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, met = api.loss(params, tb, _settings(CHUNK))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL,
                               atol=TOL)
    assert met["tokens"].item() == float(jmet["tokens"]) == B * S - 5
    for g, w in zip([t.grad for t in leaves], jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    with torch.no_grad():
        plain, _ = api.loss(params, tb, _settings(0))
        odd, _ = api.loss(params, tb, _settings(24))      # 24 ∤ 64
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=TOL,
                               atol=TOL)
    assert odd.item() == plain.item()


def _engine_run(tcfg, np_params, policy, chunk, steps=2):
    api = build_model(tcfg)
    params = params_from_jax(np_params, device="cpu")
    opt = topt.sgd(1e-2)
    eng = StagedEngine(api, _settings(chunk), opt, policy=policy,
                       io_config=SpoolIoConfig(backend="mem"),
                       min_offload_elements=0)
    state = opt.init(params)
    losses = []
    try:
        for step in range(steps):
            b = _batch(tcfg.vocab_size, seed=step)
            params, state, rep = eng.train_step(params, state, [b])
            losses.append(rep.loss)
    finally:
        eng.close()
    return losses, [t.detach() for t in tree_flatten(params)[0]], eng


def test_engine_policies_bitwise_and_head_saves_no_logits(jax_model,
                                                          monkeypatch):
    _, tcfg, np_params = jax_model[0.0]
    stored = []
    real = ActivationSpool.offload

    def spy(self, key, tree):
        real(self, key, tree)
        rec = self._records[key]
        stored.append([tree[i] for i in rec["spool_idx"]])

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    keep = _engine_run(tcfg, np_params, KeepPolicy(), CHUNK)
    assert not stored
    spool = _engine_run(tcfg, np_params, SpoolPolicy(), CHUNK)
    head = stored[len(spool[2].stage_names) - 1]
    stored.clear()
    plain = _engine_run(tcfg, np_params, SpoolPolicy(), 0)
    plain_head = stored[len(plain[2].stage_names) - 1]
    monkeypatch.setattr(ActivationSpool, "offload", real)
    recompute = _engine_run(tcfg, np_params, RecomputePolicy(), CHUNK)
    for other in (spool, recompute):
        assert other[0] == keep[0]
        for a, b in zip(other[1], keep[1]):
            assert torch.equal(a, b)
    np.testing.assert_allclose(keep[0], plain[0], rtol=TOL, atol=TOL)
    V = tcfg.padded_vocab
    # chunked: the labels (B, S) int64 alone
    assert [(tuple(t.shape), t.dtype) for t in head] == [
        ((B, S), torch.int64)]
    assert all(V not in t.shape for t in head)
    # unchunked: the f32 logits among others
    assert any(tuple(t.shape) == (B, S, V) and t.dtype == torch.float32
               for t in plain_head)
