"""The port's training path (`repro_torch.core.engine`, optimizers,
session, CLI) against the JAX package and against itself.

  * Engine vs the JAX `StagedTrainer`: small-gpt and a small mamba2,
    float32, sgd, 3 steps on the same numpy batches and the same weights
    (JAX init -> numpy -> `params_from_jax`): losses within rtol 1e-5,
    params within rtol 2e-4 / atol 2e-5 (the bars of
    tests/test_system.py::test_strategies_numerically_identical).
  * AdamW (with global-norm clipping) and sgd-momentum updates on the
    same grads as the JAX optimizers, 1e-6.
  * Inside the port, bitwise: losses and params across Keep / Spool /
    Recompute / Adaptive and across fs|mem x raw|zlib|byteplane; a failed
    load that falls back to recompute changes nothing, and any other
    error in a fetch propagates; a step whose backward raises frees its
    tensors.
  * What the spool stores: no parameter storage, no stage input, the
    deduplicated non-parameter saved tensors of each stage, and a lower
    tracked peak than keep.
  * The CLI runs 2 steps on the CPU and refuses flags not ported yet.
"""
import dataclasses
import gc
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.mamba2_2_7b import CONFIG as JAX_MAMBA2  # noqa: E402
from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.core.staged import StagedTrainer  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import MAMBA2_2_7B, SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.ids import storage_ptr  # noqa: E402
from repro_torch.core.policies import (AdaptivePolicy, KeepPolicy,  # noqa
                                       RecomputePolicy, SpoolPolicy)
from repro_torch.core.spool import (SpoolLoadError,  # noqa: E402
                                    SpoolStepTransaction)
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

B, S = 2, 32
MIN_OFF = 2 ** 10
MAMBA = dict(num_layers=2, d_model=64, ssm_state_dim=16, ssm_head_dim=16,
             ssm_chunk=16, vocab_size=512, max_position=64, dtype="float32")
GPT = dict(dtype="float32")


def _cfgs(arch):
    if arch == "mamba2":
        return (dataclasses.replace(JAX_MAMBA2, **MAMBA),
                dataclasses.replace(MAMBA2_2_7B, **MAMBA))
    return (dataclasses.replace(jax_small_gpt(128, 2), **GPT),
            dataclasses.replace(small_gpt(128, 2), **GPT))


def _batches(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _jax_params(jcfg, seed=0):
    return jax_build(jcfg).init(jax.random.key(seed))


def _port_run(tcfg, jparams, policy, *, steps=3, opt=None, io=None,
              batches=None, min_off=MIN_OFF):
    api = build_model(tcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    opt = opt or topt.sgd(1e-2)
    eng = StagedEngine(api, RunSettings(attn_impl="torch", attn_chunk=64,
                                        param_dtype="float32",
                                        device="cpu"),
                       opt, policy=policy, io_config=io or SpoolIoConfig(
                           backend="mem"), min_offload_elements=min_off)
    state = opt.init(params)
    reps = []
    try:
        for b in (batches or _batches(tcfg.vocab_size, steps)):
            params, state, rep = eng.train_step(params, state, [b])
            reps.append(rep)
    finally:
        eng.close()
    return [r.loss for r in reps], params, reps, eng


@pytest.fixture(scope="module", params=["small-gpt", "mamba2"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def keep_run(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams = _jax_params(jcfg)
    losses, params, reps, _ = _port_run(tcfg, jparams, KeepPolicy())
    return jcfg, tcfg, jparams, losses, params, reps


def _flat(params):
    return [t.detach() for t in tree_flatten(params)[0]]


def _bitwise(a, b):
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)


def test_engine_matches_jax_staged_trainer(keep_run):
    jcfg, tcfg, jparams, losses, params, _ = keep_run
    japi = jax_build(jcfg)
    opt = jopt.sgd(1e-2)
    tr = StagedTrainer(japi, JaxSettings(attn_impl="xla", attn_chunk=64,
                                         param_dtype="float32"),
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


def test_adamw_one_step_matches_jax_staged_trainer(keep_run):
    """One adamw step (lr 1e-3, clip 1.0) through both engines. Step 1's
    update is g / (|g| + eps) per element, so where |g| is near its
    rounding noise the last digits of g move the update by a fraction of
    lr: params within atol 1e-4 (a tenth of lr), the loss within 1e-5."""
    jcfg, tcfg, jparams, _, _, _ = keep_run
    b = _batches(tcfg.vocab_size, 1)
    losses, params, _, _ = _port_run(tcfg, jparams, KeepPolicy(),
                                     opt=topt.adamw(1e-3), batches=b)
    opt = jopt.adamw(1e-3)
    tr = StagedTrainer(jax_build(jcfg), JaxSettings(
        attn_impl="xla", attn_chunk=64, param_dtype="float32"), opt,
        strategy="keep", min_offload_elements=MIN_OFF)
    try:
        p, _, rep = tr.train_step(jparams, opt.init(jparams), [
            {k: jnp.asarray(v) for k, v in b[0].items()}])
    finally:
        tr.close()
    np.testing.assert_allclose(losses[0], rep.loss, rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    for got, w in zip(_flat(params), _flat(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-4)


def test_data_pipeline_matches_jax():
    """The numpy-only copy draws the JAX package's batches bit for bit."""
    from repro.data import pipeline as jdata
    from repro_torch.data import pipeline as tdata
    for shard, step in ((0, 0), (1, 5)):
        a = jdata.SyntheticMarkovLM(300, seed=4).batch(shard, step, 3, 17)
        b = tdata.SyntheticMarkovLM(300, seed=4).batch(shard, step, 3, 17)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    docs = [np.arange(5), np.arange(9), np.arange(2)]
    np.testing.assert_array_equal(jdata.pack_documents(docs, 6, 99),
                                  tdata.pack_documents(docs, 6, 99))
    loader = tdata.ShardedLoader(tdata.SyntheticMarkovLM(300, seed=4),
                                 global_batch=4, seq_len=8, num_hosts=2,
                                 host_id=1)
    try:
        first = next(loader)
        assert first["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(
            first["tokens"], jdata.SyntheticMarkovLM(300, seed=4).batch(
                1, 0, 2, 8)["tokens"])
        assert loader.state_dict()["step"] == 1
    finally:
        loader.close()


@pytest.mark.parametrize("policy", [SpoolPolicy, RecomputePolicy,
                                    AdaptivePolicy])
def test_policies_bitwise_equal_to_keep(keep_run, policy):
    _, tcfg, jparams, losses, params, _ = keep_run
    got, p, reps, eng = _port_run(tcfg, jparams, policy())
    assert got == losses
    _bitwise(p, params)
    if policy is SpoolPolicy:
        assert all(r.extra["stages_offloaded"] == len(eng.stage_names)
                   == r.extra["stages_fetched"] for r in reps)
    if policy is RecomputePolicy:
        assert reps[0].extra["stages_recomputed"] == tcfg.num_layers
    if policy is AdaptivePolicy:
        assert eng.plan is not None and not eng.plan.offload[-1]


@pytest.mark.parametrize("backend", ["fs", "mem"])
@pytest.mark.parametrize("codec", ["raw", "zlib", "byteplane"])
def test_backends_and_codecs_bitwise(keep_run, backend, codec, tmp_path):
    _, tcfg, jparams, losses, params, _ = keep_run
    io = SpoolIoConfig(backend=backend, codec=codec,
                       directory=str(tmp_path) if backend == "fs" else None)
    got, p, reps, eng = _port_run(tcfg, jparams, SpoolPolicy(), steps=2,
                                  io=io)
    assert got == losses[:2]
    assert reps[-1].stats.bytes_offloaded > 0
    assert eng.spool.backend.keys() == []
    if backend == "fs":
        assert list(tmp_path.iterdir()) == []


def test_failed_fetch_falls_back_to_recompute(keep_run, monkeypatch):
    _, tcfg, jparams, losses, params, _ = keep_run
    real = SpoolStepTransaction.fetch
    failed = []

    def flaky(self, stage):
        if stage == 2 and not failed:
            failed.append(stage)
            raise SpoolLoadError("injected: blob lost")
        return real(self, stage)

    monkeypatch.setattr(SpoolStepTransaction, "fetch", flaky)
    got, p, reps, eng = _port_run(tcfg, jparams, SpoolPolicy())
    assert failed == [2] and eng.spool.stats.fetch_fallbacks == 1
    assert got == losses
    _bitwise(p, params)


def test_other_fetch_errors_propagate(keep_run, monkeypatch):
    """Only a failed load degrades to recompute: any other error raised
    while fetching (a device fault, out of memory) reaches the caller."""
    _, tcfg, jparams, _, _, _ = keep_run

    def broken(self, stage):
        raise RuntimeError("injected: device fault")

    monkeypatch.setattr(SpoolStepTransaction, "fetch", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        _port_run(tcfg, jparams, SpoolPolicy(), steps=1)


class _BackwardFault(RuntimeError):
    pass


class _RaiseInBackward(torch.autograd.Function):
    """Identity whose backward raises, as an out-of-memory error in a
    kernel's backward does on the card."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise _BackwardFault("injected: out of memory in backward")


def _live_tensor_elements():
    gc.collect()
    return sum(o.numel() for o in gc.get_objects() if torch.is_tensor(o))


@pytest.mark.parametrize("policy", [KeepPolicy, SpoolPolicy])
def test_a_step_whose_backward_raises_frees_its_tensors(keep_run, policy,
                                                        monkeypatch):
    """The error reaches the caller, and nothing of the failed step stays
    alive: the saved tensors fetched for the failing stage sit in the
    cell its unpack hook reads, and the graph that hook belongs to was
    never run, so an unemptied cell, the graph and the tensors would
    keep each other alive (invisible to the garbage collector) and the
    card's memory with them."""
    _, tcfg, jparams, _, _, _ = keep_run
    real = engine_mod.apply_block
    calls = []

    def faulty(bdef, p, x, *a, **kw):
        x, c = real(bdef, p, x, *a, **kw)
        calls.append(1)
        return (_RaiseInBackward.apply(x) if len(calls) == 2 else x), c

    _port_run(tcfg, jparams, policy(), steps=1)       # warm caches
    before = _live_tensor_elements()
    monkeypatch.setattr(engine_mod, "apply_block", faulty)
    with pytest.raises(_BackwardFault):
        _port_run(tcfg, jparams, policy(), steps=1)
    assert _live_tensor_elements() == before


def test_spool_stores_no_parameters_and_every_saved_tensor(keep_run,
                                                           monkeypatch):
    """Each stage's offloaded bytes are exactly its non-parameter saved
    tensors, deduplicated by storage/offset/shape/stride, above the
    threshold, minus views of the stage input; no offloaded leaf lies in
    a parameter's storage."""
    _, tcfg, jparams, _, _, keep_reps = keep_run
    from repro_torch.core.spool import ActivationSpool
    real = ActivationSpool.offload
    recs = []

    def spy(self, key, tree):
        real(self, key, tree)
        rec = self._records[key]
        recs.append((key, rec["nbytes"],
                     [tree[i] for i in rec["spool_idx"]]))

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    _, params, reps, eng = _port_run(tcfg, jparams, SpoolPolicy())
    pstores = {storage_ptr(t) for t in _flat(params)}
    assert len(recs) == 3 * len(eng.stage_names)
    recs = recs[:len(eng.stage_names)]              # the first step's
    for key, nbytes, leaves in recs:
        assert all(storage_ptr(t) not in pstores for t in leaves), key
        keys = {(storage_ptr(t), t.storage_offset(), tuple(t.shape),
                 t.stride()) for t in leaves}
        assert len(keys) == len(leaves), key
        assert nbytes == sum(t.numel() * t.element_size() for t in leaves)
    # an independent count: every tensor autograd saves in a plain
    # forward of the whole model, minus parameters, duplicates and the
    # tensors each layer and the head take as input (the stage inputs)
    from repro_torch.models import api as api_mod
    api = build_model(tcfg)
    assert all(len(seg.blocks) == 1 for seg in api.segments)
    inputs = set()
    real_block, real_head = api_mod.apply_block, api_mod.head

    def block(bdef, p, x, *a, **kw):
        inputs.add(storage_ptr(x))
        return real_block(bdef, p, x, *a, **kw)

    def head_in(p, x, cfg):
        inputs.add(storage_ptr(x))
        return real_head(p, x, cfg)

    monkeypatch.setattr(api_mod, "apply_block", block)
    monkeypatch.setattr(api_mod, "head", head_in)
    p2 = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for t in tree_flatten(p2)[0]:
        t.requires_grad_(True)
    pst = {storage_ptr(t) for t in _flat(p2)}
    seen = {}

    def pack(t):
        if storage_ptr(t) not in pst and t.numel() >= MIN_OFF:
            seen[(storage_ptr(t), t.storage_offset(), tuple(t.shape),
                  t.stride())] = (t, t.numel() * t.element_size())
        return t

    b = _batches(tcfg.vocab_size, 1)[0]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        api.loss(p2, {k: torch.from_numpy(v).long() for k, v in b.items()},
                 RunSettings(attn_impl="torch", attn_chunk=64,
                             param_dtype="float32", device="cpu"))
    assert inputs and any(storage_ptr(t) in inputs
                          for t, _ in seen.values())
    assert sum(n for _, n, _ in recs) == sum(
        n for t, n in seen.values() if storage_ptr(t) not in inputs)
    # spooled bytes leave the tracked footprint once written; keep holds
    # them (stores race the forward, so claim it for one step of three)
    assert min(r.peak_activation_bytes for r in reps) < min(
        r.peak_activation_bytes for r in keep_reps)


def test_spooled_tensors_leave_memory_once_written(keep_run, monkeypatch):
    """Once a stage's store lands, its spooled tensors are referenced by
    nothing (the autograd graph keeps only handles): by the start of
    backward every spooled tensor is gone. The stage inputs, which the
    engine holds as graph leaves, are never spooled."""
    import weakref

    from repro_torch.core.spool import ActivationSpool
    _, tcfg, jparams, _, _, _ = keep_run
    real_off, real_fetch = ActivationSpool.offload, SpoolStepTransaction.fetch
    refs, dead = [], []

    def spy(self, key, tree):
        real_off(self, key, tree)
        refs.extend(weakref.ref(tree[i])
                    for i in self._records[key]["spool_idx"])

    def fetch(self, stage):
        if not dead:                    # the first fetch: backward begins
            self._spool.wait_io()
            dead.append(sum(r() is None for r in refs))
        return real_fetch(self, stage)

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    monkeypatch.setattr(SpoolStepTransaction, "fetch", fetch)
    _port_run(tcfg, jparams, SpoolPolicy(), steps=1)
    assert dead[0] == len(refs) > 0


def test_optimizer_updates_match_jax():
    """One update of each optimizer on the same params and grads:
    adamw with global-norm clipping (the grads are scaled up so the clip
    bites) and sgd with momentum."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5, 4), "b": {"c": (7,), "d": (2, 6)}}

    def tree(scale):
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p, g = tree(1.0), tree(10.0)
    for jo, to in ((jopt.adamw(1e-2, clip_norm=1.0),
                    topt.adamw(1e-2, clip_norm=1.0)),
                   (jopt.sgd(1e-2, momentum=0.9), topt.sgd(1e-2,
                                                          momentum=0.9))):
        jp, js = jax.tree.map(jnp.asarray, p), None
        js = jo.init(jp)
        tp = params_from_jax(p, device="cpu")
        ts = to.init(tp)
        for _ in range(2):
            jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
            tp, ts = to.update(params_from_jax(g, device="cpu"), ts, tp)
        for a, b in zip(_flat(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_cli_trains_two_steps_on_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    train_cli.main(["--arch", "small-gpt", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "32", "--strategy", "spool",
                    "--min-offload", "4096", "--spool-backend", "fs",
                    "--spool-dir", str(tmp_path / "spool"),
                    "--metrics", str(metrics)])
    out = capsys.readouterr().out
    assert "step    2 loss" in out and "ssd_scan launches 0" in out
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["bytes_offloaded"] >= 0 and "peak_activation_bytes" in \
        rows[0]
    assert list((tmp_path / "spool").iterdir()) == []
    for bad in (["--mesh", "x"], ["--engine", "jit"], ["--opt-overlap"],
                ["--resume"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(bad)
