"""The port's model (`repro_torch.models`) against the JAX package on
one set of weights: JAX `init` -> numpy -> `params_from_jax`. Layers,
full-sequence forward with its emitted decode caches, dense and paged
decode over several steps, in float32 at 1e-4, and one bf16 prefill;
the rms_norm / GELU / SiLU autograd Functions (their grads, and that they
save only their inputs); training loss and every gradient of small-gpt,
small-bert and a 2-layer mamba2 against `build_model(cfg).loss`; the
decode steps also with learned positions (no RoPE) and with the
sqrt(d_model) embedding scale."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.mamba2_2_7b import CONFIG as JAX_MAMBA2  # noqa: E402
from repro.configs.paper_models import small_bert as jax_small_bert  # noqa
from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import RunSettings as JaxSettings  # noqa
from repro_torch.configs import MAMBA2_2_7B, resolve_config  # noqa: E402
from repro_torch.configs.paper_models import (small_bert,  # noqa: E402
                                              small_gpt)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402

TOL = 1e-4
B, S, CACHE = 2, 12, 24


def _setup(dtype, **over):
    jcfg = dataclasses.replace(jax_small_gpt(), dtype=dtype, **over)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.key(0))
    api = build_model(dataclasses.replace(small_gpt(), dtype=dtype, **over))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return (japi, jparams, JaxSettings(attn_impl="xla", attn_chunk=8,
                                       param_dtype=dtype),
            api, params, RunSettings(attn_impl="torch", attn_chunk=8,
                                     param_dtype=dtype, device="cpu"))


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


# the decode embedding as shipped (RoPE, no scale), with learned
# positions instead of RoPE, and with the sqrt(d_model) embedding scale
DECODE_VARIANTS = {"as-shipped": {}, "use_rope=False": {"use_rope": False},
                   "scale_embed=True": {"scale_embed": True}}


@pytest.fixture(scope="module", params=list(DECODE_VARIANTS))
def f32_decode(request):
    return _setup("float32", **DECODE_VARIANTS[request.param])


def _tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 2048, shape).astype(
        np.int32)


def test_configs_match_jax():
    from repro.configs.paper_models import gpt as jax_gpt
    for name, want in (("small-gpt", jax_small_gpt()),
                       ("gpt-h8192-l4", jax_gpt(8192, 4))):
        got = resolve_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    big = resolve_config("gpt-h8192-l4")
    assert (big.num_heads, big.resolved_head_dim, big.d_ff,
            big.padded_vocab) == (64, 128, 32768, 50432)
    with pytest.raises(ValueError, match="unknown arch"):
        resolve_config("qwen2.5-3b")
    # configurations the slice does not carry are refused, not run wrong
    with pytest.raises(NotImplementedError, match="activation 'silu'"):
        build_model(dataclasses.replace(small_gpt(), mlp_glu=True,
                                        act="silu"))


def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    1e-6)), rtol=1e-5, atol=1e-5)
    for pos in (np.arange(5), np.array([[7], [11]])):
        xr = x[:, :1] if pos.ndim == 2 else x
        want = jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4)
        got = layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                                1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_init_distribution():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512), 256, torch.float32)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-6      # truncated at 2 std
    # a normal truncated at +-2 sigma has std 0.8796 sigma
    assert abs(float(w.std()) * 16 - 0.8796) < 0.01
    api = build_model(small_gpt())
    params = api.init(torch.Generator().manual_seed(0))
    wq = params["segments"][0]["b0"]["attn"]["wq"]
    assert wq.shape == (4, 256, 4, 64) and wq.dtype == torch.bfloat16
    assert params["embed"].shape == (2048, 256)


def test_truncated_normal_is_the_inverse_cdf_without_erfinv(monkeypatch):
    """The init's inverse CDF stays off `erfinv`, which torch computes on
    the CPU with MKL's vector math (its first call in a process can give
    one OpenMP thread's share at a lower accuracy); each sample x of a
    uniform p on [Phi(-2), Phi(2)] has Phi(x) == p."""
    def refuse(*a, **k):
        raise AssertionError("erfinv called")

    monkeypatch.setattr(torch.Tensor, "erfinv_", refuse)
    monkeypatch.setattr(torch.Tensor, "erfinv", refuse)
    monkeypatch.setattr(torch, "erfinv", refuse)
    x = layers.truncated_normal(torch.Generator().manual_seed(3),
                                (4096,), torch.float32)
    u = torch.rand((4096,), generator=torch.Generator().manual_seed(3))
    p = u.double() * (layers._HI - layers._LO) + layers._LO
    assert float(x.abs().max()) <= 2.0
    torch.testing.assert_close(torch.special.ndtr(x.double()), p,
                               rtol=0, atol=1e-6)


def test_forward_and_caches_match_jax(f32):
    japi, jparams, jset, api, params, tset = f32
    toks = _tokens()
    jl, jc, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jset,
                             emit_cache=True, cache_len=CACHE)
    with torch.inference_mode():
        tl, tc = api.forward(params, {"tokens": torch.from_numpy(toks)},
                             tset, emit_cache=True, cache_len=CACHE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    for name in ("k", "v"):
        assert tc[0]["b0"][name].shape == (4, B, CACHE, 4, 64)
        np.testing.assert_allclose(tc[0]["b0"][name].numpy(),
                                   np.asarray(jc[0]["b0"][name]),
                                   rtol=TOL, atol=TOL)


def test_decode_steps_match_jax(f32_decode):
    """Prefill, then 4 dense decode steps, alternating per-row (B,)
    positions and one shared scalar position."""
    japi, jparams, jset, api, params, tset = f32_decode
    toks = _tokens(2)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jset,
                             cache_len=CACHE)
    with torch.inference_mode():
        _, tcache = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                tset, cache_len=CACHE)
        nxt = _tokens(3, (B, 4))
        for t in range(4):
            pos = (np.array([S + t, S + t], np.int32) if t % 2 == 0
                   else np.array(S + t, np.int32))
            jl, jcache = japi.decode_step(
                jparams, jcache, {"tokens": jnp.asarray(nxt[:, t:t + 1])},
                jnp.asarray(pos), jset)
            tl = api.decode_step(
                params, tcache, {"tokens": torch.from_numpy(nxt[:, t:t + 1])},
                torch.from_numpy(pos).long(), tset)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tcache[0]["b0"]["k"].numpy(),
                                   np.asarray(jcache[0]["b0"]["k"]),
                                   rtol=TOL, atol=TOL)


def test_paged_decode_matches_jax(f32_decode):
    """Decode against page pools and tables (different physical pages
    per row, null page 0 in the unused table entries)."""
    japi, jparams, jset, api, params, tset = f32_decode
    P, n_pages, n_phys = 4, 6, 16
    toks = _tokens(4, (B, 8))
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jset,
                             cache_len=n_pages * P)
    tables = np.zeros((B, n_pages), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :3] = [1, 7, 3]
    pools = []
    for name in ("k", "v"):
        dense = np.asarray(jcache[0]["b0"][name])        # (L, B, 24, H, D)
        pool = np.zeros((4, n_phys, P) + dense.shape[3:], np.float32)
        for b in range(B):
            for j in range(2):                           # 8 tokens, 2 pages
                pool[:, tables[b, j]] = dense[:, b, j * P:(j + 1) * P]
        pools.append(pool)
    jpools = [{"b0": {"k": jnp.asarray(pools[0]),
                      "v": jnp.asarray(pools[1])}}]
    tpools = [{"b0": {"k": torch.from_numpy(pools[0].copy()),
                      "v": torch.from_numpy(pools[1].copy())}}]
    nxt = _tokens(5, (B, 5))
    with torch.inference_mode():
        for t in range(5):                  # crosses into page 2 at t=0
            pos = np.array([8 + t, 8 + t], np.int32)
            jl, jpools, _ = japi.decode_step_paged(
                jparams, jpools, [{}], jnp.asarray(tables),
                {"tokens": jnp.asarray(nxt[:, t:t + 1])}, jnp.asarray(pos),
                jset)
            tl = api.decode_step_paged(
                params, tpools, [{}], torch.from_numpy(tables).long(),
                {"tokens": torch.from_numpy(nxt[:, t:t + 1])},
                torch.from_numpy(pos).long(), tset)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)


def test_bf16_prefill_matches_jax():
    """bf16 weights and activations: the frameworks round at different
    places, so the logits agree to bf16 precision only."""
    japi, jparams, jset, api, params, tset = _setup("bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(6, (1, 16))
    jl, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jset)
    with torch.inference_mode():
        tl, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, tset)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-2,
                               atol=5e-2)


def test_mamba2_config_matches_jax():
    got = resolve_config("mamba2-2.7b")
    assert dataclasses.asdict(got) == dataclasses.asdict(JAX_MAMBA2)
    api = build_model(dataclasses.replace(got, num_layers=2, d_model=64,
                                          ssm_state_dim=16, ssm_head_dim=16,
                                          max_position=32))
    assert [b.mixer for b in api.segments[0].blocks] == ["ssm"]
    params = api.init(torch.Generator().manual_seed(0))
    ssm = params["segments"][0]["b0"]["ssm"]
    assert ssm["w_zx"].shape == (2, 64, 256) and "mlp" not in \
        params["segments"][0]["b0"]
    assert ssm["A_log"].dtype == torch.float32
    assert params["pos_embed"].shape == (32, 64)
    with pytest.raises(NotImplementedError, match="decode caches"):
        api.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                    RunSettings(device="cpu"))


@pytest.mark.parametrize("name", ["rms_norm", "gelu", "silu"])
def test_layer_functions_save_only_inputs_and_match_jax(name):
    """Each Function saves exactly its inputs (rms_norm: x and scale;
    the activations: x) and its grads equal jax.grad of the JAX custom_vjp
    at 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    g = rng.normal(size=(2, 7, 16)).astype(np.float32)
    scale = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        if name == "rms_norm":
            y = layers.rms_norm(tx, ts, 1e-6)
        else:
            y = getattr(layers, name)(tx)
    ins = (tx, ts) if name == "rms_norm" else (tx,)
    assert len(saved) == len(ins)
    assert all(a is b for a, b in zip(saved, ins))
    got = torch.autograd.grad(y, ins, torch.from_numpy(g))
    if name == "rms_norm":
        jf = lambda a, b: (jlayers.rms_norm(a, b, 1e-6)  # noqa: E731
                           * jnp.asarray(g)).sum()
        want = jax.grad(jf, (0, 1))(jnp.asarray(x), jnp.asarray(scale))
    else:
        want = jax.grad(lambda a: (getattr(jlayers, name)(a)
                                   * jnp.asarray(g)).sum())(jnp.asarray(x))
        want = (want,)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
        if name == "rms_norm" else getattr(jlayers, name)(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["small-gpt", "mamba2", "small-bert"])
def test_loss_and_grads_match_jax(arch):
    """float32 training loss and the gradient of every parameter against
    the JAX package's `loss` on the same weights and batch: loss at 1e-5,
    grads at 1e-4 (f32 sums in other orders through 2-4 layers)."""
    if arch == "mamba2":
        kw = dict(num_layers=2, d_model=64, ssm_state_dim=16,
                  ssm_head_dim=16, ssm_chunk=16, vocab_size=512,
                  max_position=64, dtype="float32")
        jcfg = dataclasses.replace(JAX_MAMBA2, **kw)
        tcfg = dataclasses.replace(MAMBA2_2_7B, **kw)
    elif arch == "small-bert":
        jcfg = dataclasses.replace(jax_small_bert(), dtype="float32")
        tcfg = dataclasses.replace(small_bert(), dtype="float32")
    else:
        jcfg = dataclasses.replace(jax_small_gpt(), dtype="float32")
        tcfg = dataclasses.replace(small_gpt(), dtype="float32")
    japi, api = jax_build(jcfg), build_model(tcfg)
    jparams = japi.init(jax.random.key(3))
    toks = _tokens(12, (2, 33)) % tcfg.vocab_size
    toks[1, -5:] = -1                                   # masked labels
    batch = {"tokens": toks[:, :-1].clip(0), "labels": toks[:, 1:]}
    jset = JaxSettings(attn_impl="xla", attn_chunk=8, param_dtype="float32")
    (jl, _), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jset)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tl, metrics = api.loss(params, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()},
                           RunSettings(attn_impl="torch", attn_chunk=8,
                                       param_dtype="float32", device="cpu"))
    assert int(metrics["tokens"]) == 2 * 32 - 5
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = torch.autograd.grad(tl, leaves)
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    for a, b in zip(got, tree_flatten(want)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
