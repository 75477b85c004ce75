"""llama-3.2-vision-90b in the port against the JAX package, at JAX's
`reduced` (2 layers, cross-attention period 2, d_model 64, encoder_seq_len
16) in float32 on the CPU, on JAX `init` weights with every all-zero leaf
(the norm scales) perturbed by seeded noise, and numpy-seeded batches:

  * the segments (period - 1 attention blocks, then a cross block with
    the dense MLP) and `init`'s tree, leaf for leaf, against JAX's;
  * `forward` at 1e-4, `loss` at 1e-5 and every gradient at 1e-4 against
    `repro.models.api.build_model(cfg)` (the bars of test_torch_archs);
  * `prefill`, then `decode_step` and `decode_step_paged` (the attention
    K/V in page pools, the cross K/V resident per slot, read-only) at
    the bars of tests/test_models_smoke.py (2e-4 prefill, 2e-3 decode);
    paged bitwise equal to dense;
  * the staged engine name against the JAX `StagedTrainer` (stage list
    `vlm_enc, embed, seg0_l0, head`) and the jit name against a JAX jit
    session, at test_torch_jit's bars; keep = spool bitwise with every
    stored stage fetched; the exact residual counter equal to the
    engine's layer bytes;
  * `build_manager`, and so the serve CLI, refuse a vision model; the
    train CLI trains `--arch llama-3.2-vision-90b:reduced` on the CPU;
  * on the card (`cuda` marker, skipped here) the flash kernel at the
    vision layers' self- and cross-attention shapes cut in batch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SpoolIoConfig, get_config, resolve_config
from repro_torch.core.endurance import residual_bytes_per_layer
from repro_torch.core.policies import KeepPolicy, SpoolPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import vision_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_reference
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.optim import optimizers as topt
from repro_torch.session import TrainSession
from torch_one_thread import one_torch_thread  # noqa: E402,F401

try:
    import jax
    import jax.numpy as jnp
    from repro.core.staged import StagedTrainer
    from repro.models.api import build_model as jax_build
    from repro.models.transformer import RunSettings as JaxSettings
    from repro.optim import optimizers as jopt
    from repro.session import TrainSession as JSession
    from repro.session.session import resolve_config as jax_resolve
    from repro_torch.models.convert import params_from_jax
except ImportError:         # the card's machine: the cuda tests only
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="jax is the oracle")

ARCH = "llama-3.2-vision-90b"
TOL = 1e-4
B, S, SEED, LR = 2, 16, 3, 1e-2
TSET = RunSettings(attn_impl="torch", attn_chunk=8, param_dtype="float32",
                   device="cpu")
STAGES = ["vlm_enc", "embed", "seg0_l0", "head"]


def _tcfg():
    return dataclasses.replace(resolve_config(ARCH + ":reduced"),
                               dtype="float32")


def _jset(**kw):
    return JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32",
                       **kw)


@pytest.fixture(scope="module")
def model():
    """(jcfg, japi, numpy weights, tcfg, port api, port params)."""
    if jax is None:
        pytest.skip("jax is the oracle")
    jcfg = dataclasses.replace(jax_resolve(ARCH + ":reduced"),
                               dtype="float32")
    japi = jax_build(jcfg)
    leaves, tdef = jax.tree_util.tree_flatten(japi.init(jax.random.key(0)))
    rng = np.random.default_rng(100)
    w = tdef.unflatten([
        np.asarray(a) if np.asarray(a).any() else
        (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        for a in leaves])
    tcfg = _tcfg()
    return (jcfg, japi, w, tcfg, build_model(tcfg),
            params_from_jax(w, device="cpu"))


def _batch(cfg, seed, b=B, s=S, labels=True):
    """One batch of `vision_batches` (numpy)."""
    out = next(vision_batches(cfg.vocab_size, cfg.d_model,
                              cfg.encoder_seq_len, batch=b, seq_len=s,
                              seed=seed))
    if not labels:
        del out["labels"]
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return [t.detach().cpu().clone() for t in tree_flatten(tree)[0]]


# ------------------------------------------------------- build and init

@needs_jax
def test_segments_and_init_make_the_jax_tree(model):
    jcfg, japi, w, tcfg, api, params = model

    def plain(segs):
        return [([(b.mixer, b.window, b.mlp, b.dense_ff) for b in s.blocks],
                 s.n_repeat) for s in segs]

    assert plain(api.segments) == plain(japi.segments) == [
        ([("attn", 0, "dense", 0), ("cross", 0, "dense", 0)], 1)]
    full = build_model(get_config(ARCH))
    (seg,) = full.segments
    assert seg.n_repeat == 20 and [b.mixer for b in seg.blocks] == \
        ["attn"] * 4 + ["cross"]
    own = api.init(torch.Generator().manual_seed(0))

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [spec(v) for v in tree]
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert spec(own) == spec(w)
    assert set(own["segments"][0]["b1"]) == {"norm", "attn", "mlp",
                                             "mlp_norm"}


# -------------------------------------------------------- model parity

@needs_jax
def test_forward_loss_and_grads_match_jax(model):
    jcfg, japi, w, tcfg, api, params = model
    jw = jax.tree.map(jnp.asarray, w)
    fb = _batch(tcfg, 1, labels=False)
    jl, _ = japi.forward(jw, _to_jax(fb), _jset())
    with torch.inference_mode():
        tl = api.forward(params, _to_torch(fb), TSET)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    batch = _batch(tcfg, 2)
    batch["labels"][1, -3:] = -1
    (jloss, jm), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jw, _to_jax(batch), _jset())
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, tm = api.loss(params, _to_torch(batch), TSET)
        got = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * S - 3
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jg),
                                        device="cpu"))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL)
    # the cross block's K/V projections learn from the patch embeddings
    cross = params["segments"][0]["b1"]["attn"]["wk"]
    assert float(dict(zip(map(id, leaves), got))[id(cross)].abs().max()) > 0


def _pages(caches, paged_ids, tables, P, n_phys):
    """Page pools (per segment {bid: {"k", "v"}}, (L, n_phys, P, H, D))
    holding each row's dense prefill K/V of the paged blocks at its
    table's pages, and the resident entries (the rest, as they are)."""
    pools, resident = [], []
    for seg, ids in zip(caches, paged_ids):
        pool_seg, res_seg = {}, {}
        for bid, entry in seg.items():
            if bid not in ids:
                res_seg[bid] = {k: v.copy() for k, v in entry.items()}
                continue
            kv = {}
            for name in ("k", "v"):
                dense = entry[name]                       # (L, B, S, H, D)
                pool = np.zeros((dense.shape[0], n_phys, P)
                                + dense.shape[3:], dense.dtype)
                for b in range(dense.shape[1]):
                    for j in range(dense.shape[2] // P):
                        pool[:, tables[b, j]] = dense[:, b, j * P:(j + 1) * P]
                kv[name] = pool
            pool_seg[bid] = kv
        pools.append(pool_seg)
        resident.append(res_seg)
    return pools, resident


@needs_jax
def test_prefill_and_decode_steps_match_jax(model):
    """Prefill 13 tokens with their patch embeddings, then 4 dense and 4
    paged decode steps (positions 13-16, crossing into the fifth page of
    4 tokens): JAX at tests/test_models_smoke.py's bars; paged bitwise
    equal to dense; the cross entries resident and never written."""
    from repro_torch.kvcache.adapters import paged_block_ids
    jcfg, japi, w, tcfg, api, params = model
    jw = jax.tree.map(jnp.asarray, w)
    P, n_pages, n_phys, cache = 4, 5, 16, 20
    full = _batch(tcfg, 4, s=17, labels=False)
    pre = {"tokens": full["tokens"][:, :13],
           "enc_embeddings": full["enc_embeddings"]}
    jlast, jcache = japi.prefill(jw, _to_jax(pre), _jset(), cache_len=cache)
    with torch.inference_mode():
        want = api.forward(params, _to_torch(full), TSET)
        last, tcache = api.prefill(params, _to_torch(pre), TSET,
                                   cache_len=cache)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(last[:, 0].numpy(), want[:, 12].numpy(),
                               rtol=2e-4, atol=2e-4)
    cross = tcache[0]["b1"]
    assert cross["k"].shape[:3] == (1, B, tcfg.encoder_seq_len)
    ids = paged_block_ids(api.segments, n_pages * P)
    assert ids == [{"b0"}]
    tables = np.zeros((B, n_pages), np.int64)
    tables[0] = [5, 2, 9, 11, 0]
    tables[1] = [1, 7, 3, 13, 4]
    numpy_cache = [{bid: {k: v.numpy() for k, v in e.items()}
                    for bid, e in seg.items()} for seg in tcache]
    pools, resident = _pages(numpy_cache, ids, tables, P, n_phys)
    tpools = [{b: {k: torch.from_numpy(v) for k, v in e.items()}
               for b, e in seg.items()} for seg in pools]
    tres = [{b: {k: torch.from_numpy(v) for k, v in e.items()}
             for b, e in seg.items()} for seg in resident]
    cross_before = tres[0]["b1"]["k"].clone()
    with torch.inference_mode():
        for t in range(4):
            pos = np.full((B,), 13 + t, np.int64)
            step = {"tokens": full["tokens"][:, 13 + t:14 + t]}
            jl, jcache = japi.decode_step(jw, jcache, _to_jax(step),
                                          jnp.asarray(pos, jnp.int32),
                                          _jset())
            dense = api.decode_step(params, tcache, _to_torch(step),
                                    torch.from_numpy(pos), TSET)
            paged = api.decode_step_paged(
                params, tpools, tres, torch.from_numpy(tables),
                _to_torch(step), torch.from_numpy(pos), TSET)
            np.testing.assert_allclose(dense.numpy(), np.asarray(jl),
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(dense[:, 0].numpy(),
                                       want[:, 13 + t].numpy(), rtol=2e-3,
                                       atol=2e-3)
            assert torch.equal(paged, dense)
    assert torch.equal(tres[0]["b1"]["k"], cross_before)


# ------------------------------------------------------------- engines

@needs_jax
def test_staged_engine_matches_jax_staged_trainer(model):
    from repro_torch.core.engine import StagedEngine
    jcfg, japi, w, tcfg, api, params = model
    steps = [[_batch(tcfg, 10 + i)] for i in range(2)]
    opt = topt.sgd(LR)
    eng = StagedEngine(api, TSET, opt, policy=KeepPolicy(),
                       io_config=SpoolIoConfig(backend="mem"))
    p = params_from_jax(w, device="cpu")
    state, losses = opt.init(p), []
    try:
        for mbs in steps:
            p, state, rep = eng.train_step(p, state, mbs)
            losses.append(rep.loss)
    finally:
        eng.close()
    jo = jopt.sgd(LR)
    tr = StagedTrainer(japi, _jset(), jo, strategy="keep")
    jp, jst, jl = jax.tree.map(jnp.asarray, w), None, []
    jst = jo.init(jp)
    try:
        assert eng.stage_names == [s.name for s in tr._stages] == STAGES
        for mbs in steps:
            jp, jst, rep = tr.train_step(jp, jst, [_to_jax(b) for b in mbs])
            jl.append(rep.loss)
    finally:
        tr.close()
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)
    for got, want in zip(tree_flatten(p)[0], tree_flatten(params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5)


@needs_jax
def test_jit_name_matches_a_jax_jit_session():
    """The jit name (layers recomputed, the session default) against a
    JAX jit session on the JAX init's weights and the same batches."""
    tcfg = _tcfg()
    jcfg = dataclasses.replace(jax_resolve(ARCH + ":reduced"),
                               dtype="float32")

    def loader():
        return vision_batches(tcfg.vocab_size, tcfg.d_model,
                              tcfg.encoder_seq_len, batch=B, seq_len=S,
                              seed=SEED)

    jsess = JSession(jcfg, engine="jit", batch_size=B, seq_len=S, seed=SEED,
                     lr=LR, optimizer=jopt.sgd(LR), loader=loader(),
                     settings=_jset(activation_policy="remat"))
    try:
        jres = jsess.run(2)
        jparams = [np.asarray(x) for x in jax.tree.leaves(jsess.state.params)]
    finally:
        jsess.close()
    with TrainSession(tcfg, engine="jit", device="cpu", batch_size=B,
                      seq_len=S, seed=SEED, optimizer=topt.sgd(LR),
                      loader=loader()) as s:
        s.params = params_from_jax(jax.tree.map(
            np.asarray, jax_build(jcfg).init(jax.random.key(SEED))),
            device="cpu")
        s.opt_state = s.optimizer.init(s.params)
        res = s.run(2)
        assert s.engine.stage_names == STAGES
        params = _flat(s.params)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5)
    assert len(params) == len(jparams)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-4)


def _session_run(policy, io=None, steps=2):
    tcfg = _tcfg()
    loader = vision_batches(tcfg.vocab_size, tcfg.d_model,
                            tcfg.encoder_seq_len, batch=B, seq_len=S,
                            seed=SEED)
    with TrainSession(tcfg, device="cpu", policy=policy, io=io,
                      loader=loader, optimizer=topt.sgd(LR),
                      min_offload_elements=0) as s:
        res = s.run(steps)
        return res.losses, _flat(s.params), res.reports, s.engine


def test_keep_equals_spool_and_the_counter(tmp_path):
    lk, pk, _, eng = _session_run(KeepPolicy())
    assert eng.stage_names == STAGES
    ls, ps, reps, _ = _session_run(SpoolPolicy(), SpoolIoConfig(
        backend="fs", directory=str(tmp_path)))
    assert lk == ls and all(np.isfinite(lk))
    assert all(torch.equal(a, b) for a, b in zip(pk, ps))
    assert all(r.extra["stages_offloaded"] == r.extra["stages_fetched"]
               == len(STAGES) for r in reps)
    assert list(tmp_path.iterdir()) == []
    tcfg = _tcfg()
    per = residual_bytes_per_layer(tcfg, B, S, offloadable_only=False,
                                   attn_impl="torch")
    assert reps[0].extra["layer_saved_bytes"] == tcfg.num_layers * per > 0


# ------------------------------------------------------ serving and CLI

def test_serving_refuses_and_the_train_cli_trains(capsys):
    from repro_torch.kvcache import KVCacheConfig, build_manager
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    tcfg = _tcfg()
    api = build_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0))
    for kind in ("paged", "dense"):
        with pytest.raises(ValueError, match="vision model"):
            build_manager(kind, api, params, TSET,
                          KVCacheConfig(page_tokens=8, max_seq_len=48), 2)
    with pytest.raises(ValueError, match="vision model"):
        serve_cli.main(["--arch", ARCH + ":reduced", "--device", "cpu",
                        "--cache", "dense", "--requests", "2"])
    with pytest.raises(ValueError, match="vision_batches"):
        TrainSession(ARCH + ":reduced", device="cpu")
    train_cli.main(["--arch", ARCH + ":reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "32",
                    "--strategy", "spool", "--spool-backend", "mem",
                    "--min-offload", "0"])
    assert "done: 2 steps" in capsys.readouterr().out


# ------------------------------------------------------ the card's shapes

# (B, Sq, Skv, Hq, Hkv, D, causal): the vision layers' self-attention
# and cross-attention over the 1024 patch embeddings, at B=1
VISION_FLASH = [(1, 1024, 1024, 64, 8, 128, True),
                (1, 1024, 1024, 64, 8, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", VISION_FLASH, ids=["self", "cross"])
def test_vision_flash_shapes_match_plain(case):
    """The bf16 tensor-core kernel at the vision shapes against the plain
    attention, within 2^-6 of each row's largest output; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    B_, Sq, Skv, Hq, Hkv, D, causal = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((B_, Sq, Hq, D), (B_, Skv, Hkv, D),
                         (B_, Skv, Hkv, D)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(),
                               causal=causal)
    d = (out.float() - want).abs()
    assert bool((d <= 2 ** -6 * want.abs().amax(-1, keepdim=True)).all())
