"""The registry's dense, audio-encoder and MoE archs in the port against
the JAX package: configs, model parity and the three smoke checks.

  * Config parity: every registry id and every `<id>:reduced`, field for
    field; `ARCH_IDS`, `grid()` and `cell_skip_reason` as JAX has them.
  * qwen2.5-3b, granite-3-2b, granite-8b, gemma2-27b, hubert-xlarge,
    llama4-scout and kimi-k2 at JAX's `reduced(...)` in f32, on JAX
    `init` weights with every all-zero leaf (qkv biases, norm scales)
    perturbed by seeded noise, so a missing bias or swapped post norms
    cannot pass: the forward and its caches at 1e-4, the loss (with the
    MoE aux terms, and every metric) at 1e-5 and every gradient at 1e-4
    against `build_model(cfg).loss`, dense and paged decode steps at
    1e-4 (decoders; gemma2's local layers decode through ring caches
    past their window). `tests/test_torch_moe.py` holds the MoE layer's
    pieces and the engines.
  * The three checks of `tests/test_models_smoke.py` on the port's own
    init for every id (llama-3.2-vision with its patch embeddings;
    `tests/test_torch_vision.py` holds it against JAX).
  * hubert trains through `TrainSession` with a loader of frame
    embeddings, keep = spool bitwise; without a loader the session
    refuses with a ValueError naming the loader.
  * The D=80 flash instance: its tile and warp mirrors on the CPU; on
    the card (`cuda` marker, skipped here) the kernel against the plain
    attention. The card's machine has no jax: only the JAX-held tests
    need it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import SpoolIoConfig, get_config, resolve_config
from repro_torch.core.policies import KeepPolicy, SpoolPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.data.pipeline import embedding_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_reference
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import RunSettings
from repro_torch.optim.optimizers import sgd
from repro_torch.session import TrainSession
from torch_one_thread import one_torch_thread  # noqa: E402,F401

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models.api import build_model as jax_build
    from repro.models.transformer import RunSettings as JaxSettings
    from repro.session.session import resolve_config as jax_resolve
except ImportError:         # the card's machine: the cuda test only
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="jax is the oracle")

TOL = 1e-4
B, S, CACHE = 2, 12, 24
PARITY = ["qwen2.5-3b", "granite-3-2b", "granite-8b", "gemma2-27b",
          "hubert-xlarge", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
SMOKE_IDS = list(T_ARCH_IDS)
TSET = RunSettings(attn_impl="torch", attn_chunk=8, param_dtype="float32",
                   device="cpu")


def _jset():
    return JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")


def perturbed_jax_weights(japi, seed=0):
    """JAX `init` weights as numpy, every all-zero leaf (biases, norm
    scales stored as scale - 1) replaced by seeded noise."""
    leaves, tdef = jax.tree_util.tree_flatten(japi.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return tdef.unflatten(out)


def batch_of(cfg, rng, b=B, s=S):
    """Inputs ({"tokens"} or {"embeddings"}, and a vision model's
    {"enc_embeddings"}) and labels as numpy."""
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.input_kind == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == "vlm":
        out["enc_embeddings"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=PARITY)
def model(request):
    """(arch, jcfg, japi, numpy weights, tcfg, port api, port params)."""
    if jax is None:
        pytest.skip("jax is the oracle")
    arch = request.param
    jcfg = dataclasses.replace(jax_resolve(arch + ":reduced"),
                               dtype="float32")
    tcfg = dataclasses.replace(resolve_config(arch + ":reduced"),
                               dtype="float32")
    japi = jax_build(jcfg)
    w = perturbed_jax_weights(japi)
    return (arch, jcfg, japi, w, tcfg, build_model(tcfg),
            params_from_jax(w, device="cpu"))


# ------------------------------------------------------------ configs

@needs_jax
def test_registry_matches_jax():
    assert T_ARCH_IDS == jreg.ARCH_IDS
    from repro_torch.configs import cell_skip_reason, get_shape, grid
    assert grid() == jreg.grid()
    for arch in T_ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert cell_skip_reason(get_config(arch), get_shape(shape)) \
                == jreg.cell_skip_reason(jreg.get_config(arch),
                                         jreg.get_shape(shape))
            assert dataclasses.asdict(get_shape(shape)) == \
                dataclasses.asdict(jreg.get_shape(shape))


@needs_jax
@pytest.mark.parametrize("name", [a + r for a in T_ARCH_IDS
                                  for r in ("", ":reduced")])
def test_resolve_config_matches_jax_field_for_field(name):
    assert dataclasses.asdict(resolve_config(name)) == \
        dataclasses.asdict(jax_resolve(name))


def test_vision_still_refuses():
    """Once a refusal, now the check that vision builds: its 100 layers
    are 20 periods of four attention blocks and a cross block; an
    unknown arch still refuses."""
    (seg,) = build_model(get_config("llama-3.2-vision-90b")).segments
    assert seg.n_repeat == 20
    assert [b.mixer for b in seg.blocks] == ["attn"] * 4 + ["cross"]
    with pytest.raises(ValueError, match="unknown arch"):
        resolve_config("nope:reduced")


# ------------------------------------------------------ model parity

def test_forward_and_caches_match_jax(model):
    arch, jcfg, japi, w, tcfg, api, params = model
    batch = batch_of(tcfg, np.random.default_rng(1))
    del batch["labels"]
    jl, jc, _ = japi.forward(jax.tree.map(jnp.asarray, w), _to_jax(batch),
                             _jset(), emit_cache=True, cache_len=CACHE)
    with torch.inference_mode():
        tl, tc = api.forward(params, _to_torch(batch), TSET,
                             emit_cache=True, cache_len=CACHE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    for seg_t, seg_j in zip(tc, jc):
        assert sorted(seg_t) == sorted(seg_j)
        for bid in seg_t:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    seg_t[bid][name].numpy(), np.asarray(seg_j[bid][name]),
                    rtol=TOL, atol=TOL)


def test_loss_and_grads_match_jax(model):
    arch, jcfg, japi, w, tcfg, api, params = model
    batch = batch_of(tcfg, np.random.default_rng(2), s=16)
    batch["labels"][1, -3:] = -1                       # masked labels
    (jl, jm), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, w), _to_jax(batch), _jset())
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    try:
        tl, tm = api.loss(params, _to_torch(batch), TSET)
        got = torch.autograd.grad(tl, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * 16 - 3
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    if tcfg.moe_num_experts:             # the aux terms are in the loss
        assert tm["loss"].item() > tm["ce"].item()
    want = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jg),
                                        device="cpu"))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL)


def test_decode_steps_match_jax(model):
    """Prefill 14 tokens, then 4 dense decode steps (positions 14-17:
    gemma2's local layers, window 16 at `reduced`, wrap their ring),
    alternating per-row and shared positions."""
    arch, jcfg, japi, w, tcfg, api, params = model
    if not tcfg.has_decode:
        pytest.skip(f"{arch} is encoder-only: no decode step")
    jw = jax.tree.map(jnp.asarray, w)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (B, 14)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab_size, (B, 4)).astype(np.int32)
    _, jcache = japi.prefill(jw, {"tokens": jnp.asarray(toks)}, _jset(),
                             cache_len=CACHE)
    with torch.inference_mode():
        _, tcache = api.prefill(params, {"tokens": torch.from_numpy(toks)
                                         .long()}, TSET, cache_len=CACHE)
        for t in range(4):
            pos = (np.full((B,), 14 + t, np.int32) if t % 2 == 0
                   else np.array(14 + t, np.int32))
            step = {"tokens": nxt[:, t:t + 1]}
            jl, jcache = japi.decode_step(jw, jcache, _to_jax(step),
                                          jnp.asarray(pos), _jset())
            tl = api.decode_step(params, tcache, _to_torch(step),
                                 torch.from_numpy(pos).long(), TSET)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)


def test_paged_decode_matches_jax(model):
    """Decode against page pools and tables (every block paged: at 16
    cached tokens gemma2's window of 16 is full attention), 4 steps that
    cross a page boundary."""
    arch, jcfg, japi, w, tcfg, api, params = model
    if not tcfg.has_decode:
        pytest.skip(f"{arch} is encoder-only: no decode step")
    jw = jax.tree.map(jnp.asarray, w)
    P, n_pages, n_phys = 4, 4, 12
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (B, 7)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab_size, (B, 4)).astype(np.int32)
    _, jcache = japi.prefill(jw, {"tokens": jnp.asarray(toks)}, _jset(),
                             cache_len=n_pages * P)
    tables = np.zeros((B, n_pages), np.int32)
    tables[0] = [5, 2, 9, 0]
    tables[1] = [1, 7, 3, 0]
    jpools, tpools = [], []
    for seg in jcache:
        jseg, tseg = {}, {}
        for bid, entry in seg.items():
            kv = {}
            for name in ("k", "v"):
                dense = np.asarray(entry[name])       # (L, B, 16, H, D)
                pool = np.zeros((dense.shape[0], n_phys, P)
                                + dense.shape[3:], np.float32)
                for b in range(B):
                    for j in range(2):                # 7 tokens, 2 pages
                        pool[:, tables[b, j]] = dense[:, b,
                                                      j * P:(j + 1) * P]
                kv[name] = pool
            jseg[bid] = {k: jnp.asarray(v) for k, v in kv.items()}
            tseg[bid] = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
        jpools.append(jseg)
        tpools.append(tseg)
    resident = [{} for _ in jcache]
    with torch.inference_mode():
        for t in range(4):                 # positions 7-10: page 1 to 2
            pos = np.full((B,), 7 + t, np.int32)
            step = {"tokens": nxt[:, t:t + 1]}
            jl, jpools, _ = japi.decode_step_paged(
                jw, jpools, resident, jnp.asarray(tables), _to_jax(step),
                jnp.asarray(pos), _jset())
            tl = api.decode_step_paged(
                params, tpools, resident, torch.from_numpy(tables).long(),
                _to_torch(step), torch.from_numpy(pos).long(), TSET)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)


def test_new_leaves_convert_key_for_key(model):
    """Every JAX leaf lands on the port's key with the port init's shape
    and dtype (qkv biases, post norms, frontend_proj among them)."""
    arch, jcfg, japi, w, tcfg, api, params = model
    own = api.init(torch.Generator().manual_seed(0))

    def paths(tree, pre=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from paths(v, pre + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from paths(v, pre + (i,))
        else:
            yield pre, (tuple(tree.shape), tree.dtype)

    assert dict(paths(params)) == dict(paths(own))
    keys = {p[-2] if p[-1] == "scale" else p[-1] for p, _ in paths(own)}
    want = {"qwen2.5-3b": {"bq", "bk", "bv"},
            "gemma2-27b": {"post_norm", "mlp_post_norm"},
            "hubert-xlarge": {"frontend_proj", "pos_embed"}}.get(arch, set())
    assert want <= keys
    assert ("embed" in keys) == (tcfg.input_kind == "tokens")


# ------------------------------------------- tests/test_models_smoke.py

def _reduced32(arch):
    return dataclasses.replace(resolve_config(arch + ":reduced"),
                               dtype="float32")


@pytest.mark.parametrize("arch", SMOKE_IDS)
def test_forward_shapes_no_nans(arch):
    cfg = _reduced32(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        logits = api.forward(params, _to_torch(batch_of(
            cfg, np.random.default_rng(0), s=16)), TSET)
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


@pytest.mark.parametrize("arch", SMOKE_IDS)
def test_train_step_decreases_loss(arch):
    cfg = _reduced32(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1))
    batch = _to_torch(batch_of(cfg, np.random.default_rng(0), s=16))
    leaves = tree_flatten(params)[0]
    losses = []
    for _ in range(4):
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = api.loss(params, batch, TSET)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.requires_grad_(False)
                t.sub_(0.05 * g)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]          # same-batch loss must drop


@pytest.mark.parametrize("arch", [a for a in SMOKE_IDS
                                  if get_config(a).has_decode])
def test_prefill_decode_consistency(arch):
    """Decoding token t with the prefill cache matches the full-sequence
    forward logits at position t (the serving invariant)."""
    cfg = _reduced32(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16)))
    enc = ({"enc_embeddings": torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))}
        if cfg.family == "vlm" else {})
    with torch.inference_mode():
        full = api.forward(params, dict(enc, tokens=toks), TSET)
        last, caches = api.prefill(params, dict(enc, tokens=toks[:, :15]),
                                   TSET, cache_len=16)
        dec = api.decode_step(params, caches, {"tokens": toks[:, 15:]},
                              torch.tensor(15), TSET)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, 14].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, 15].numpy(),
                               rtol=2e-3, atol=2e-3)


# ------------------------------------------------ hubert in a session

def _hubert_run(policy, io, loader_seed=0, steps=2):
    cfg = resolve_config("hubert-xlarge:reduced")
    loader = embedding_batches(cfg.d_model, cfg.vocab_size, batch=2,
                               seq_len=32, seed=loader_seed)
    with TrainSession(cfg, device="cpu", policy=policy, io=io, loader=loader,
                      optimizer=sgd(1e-2), min_offload_elements=0) as s:
        res = s.run(steps)
        names = s.engine.stage_names
        return (res.losses, [t.clone() for t in tree_flatten(s.params)[0]],
                res.reports, names)


def test_hubert_trains_through_a_loader_keep_equals_spool():
    lk, pk, _, names = _hubert_run(KeepPolicy(), None)
    ls, ps, reps, _ = _hubert_run(SpoolPolicy(),
                                  SpoolIoConfig(backend="mem"))
    assert names == ["embed", "seg0_l0", "seg0_l1", "head"]
    assert lk == ls and all(np.isfinite(lk))
    assert all(torch.equal(a, b) for a, b in zip(pk, ps))
    assert all(r.extra["stages_fetched"] == r.extra["stages_offloaded"] == 4
               for r in reps)


def test_an_embeddings_arch_without_a_loader_is_refused():
    with pytest.raises(ValueError, match="loader"):
        TrainSession("hubert-xlarge:reduced", device="cpu")


# ------------------------------------------------- the D=80 instance

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): D=80 ragged, hubert's
# bidirectional shape cut in length, GQA with a window and a cap
D80_CASES = [(1, 96, 96, 2, 2, 80, True, 0, 0.0),
             (2, 200, 200, 4, 4, 80, False, 0, 0.0),
             (1, 130, 130, 4, 2, 80, True, 48, 30.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_80_plan_and_mirrors(dtype):
    """The D=80 instance's tiling (bf16: 64 query rows of 4 warps, 64-key
    tiles, rows padded to 88) and its tile and warp-live mirrors: every
    tile with an unmasked pair loaded, no warp running a tile without
    one."""
    assert 80 in fa.HEAD_DIMS
    plan = fa.flash_plan(80, dtype)
    if dtype == torch.bfloat16:
        assert plan == dict(bq=64, bk=64, threads=128,
                            smem=2 * 88 * (64 + 4 * 64))
    else:
        assert plan == dict(bq=128, bk=32, threads=128,
                            smem=4 * (128 * 84 + 2 * 32 * 80))
    for _, Sq, Skv, _, _, _, causal, window, _ in D80_CASES:
        bq, bk = plan["bq"], plan["bk"]
        rows = np.arange(Sq)[:, None]
        cols = np.arange(Skv)[None, :]
        keep = (cols < Skv) & (rows < Sq)
        if causal:
            keep = keep & (cols <= rows)
        if window:
            keep = keep & (cols > rows - window)
        for q0 in range(0, Sq, bq):
            tiles = list(fa.kv_tiles(q0, bq, bk, Sq, Skv, causal, window))
            for t in range(-(-Skv // bk)):
                need = keep[q0:q0 + bq, t * bk:(t + 1) * bk].any()
                assert need <= (t in tiles)
                if dtype != torch.bfloat16 or t not in tiles:
                    continue
                for r in range(q0, min(q0 + bq, Sq), 16):
                    live = keep[r:r + 16, t * bk:(t + 1) * bk].any()
                    assert fa.warp_live(t * bk, r, bk, Sq, causal,
                                        window) == live


@pytest.mark.cuda
@pytest.mark.parametrize("case", D80_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2 ** -6)])
def test_head_dim_80_kernel_matches_plain(case, dtype, tol):
    """The hand-written D=80 instances on the card against the plain
    attention (f32: 2e-5 abs + rel; bf16: 2^-6 of each row's largest
    output, the tensor-core kernel's bar); one launch, no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    B_, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B_, Sq, Hq, D), (B_, Skv, Hkv, D),
                         (B_, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), **kw)
    d = (out.float() - want).abs()
    if dtype == torch.float32:
        assert bool((d <= tol + tol * want.abs()).all())
    else:
        assert bool((d <= tol * want.abs().amax(-1, keepdim=True)).all())
