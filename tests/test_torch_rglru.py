"""The port's RG-LRU scan and mixer against the JAX package: the plain
step-by-step recurrence (`kernels/rglru_scan.py::rglru_sequential`, which
the `rglru_scan` wrapper runs on CPU tensors) against JAX's Pallas kernel
in interpret mode and its sequential oracle, the port's oracle
`ref.rglru_reference` against JAX's, gradients through the `rglru_scan`
autograd Function (its reverse-recurrence backward) against the JAX
`ops.rglru_scan` VJP, the tanh-GELU and f32-product Functions, and the
RG-LRU mixer `apply_rglru` on JAX weights. `rglru_chunked`, the
kernel's three chunk-parallel passes in plain PyTorch, is held against
the same oracles both ways, with its fused dlog_a against the JAX VJP.
Inputs come from numpy seeds; the CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.recurrentgemma_9b import CONFIG as JAX_RG  # noqa: E402
from repro.kernels import ops, ref as jref  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels.ref import rglru_reference  # noqa: E402
from repro_torch.kernels.rglru_scan import (CHUNK,  # noqa: E402
                                            dlog_a_scale, rglru_chunked,
                                            rglru_scan,
                                            rglru_scan_bwd, rglru_scan_fwd,
                                            rglru_sequential, scan_scale)
from repro_torch.models import layers, rglru  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

# (B, S, W, chunk, blk_w): tests/test_kernels.py::RGLRU_CASES
RGLRU_CASES = [
    (1, 64, 16, 256, 512),
    (2, 128, 32, 32, 16),
    (1, 100, 8, 256, 512),
]
TOL = 1e-5           # the JAX package's forward bar for the RG-LRU kernel
TOL_GRAD = 5e-4      # and its gradient bar
# the chunked passes' shapes: the JAX cases, S ragged over chunks of 64,
# S shorter than a chunk
CHUNKED_CASES = [(B, S, W) for B, S, W, _, _ in RGLRU_CASES] + [
    (1, 300, 8), (2, 40, 8)]
# log_a: -|N(0, 0.5)| (the JAX tests'), uniform in [-20, 0], and Griffin's
# trained, slow gates, uniform in [-1e-3, 0], where h grows to O(sqrt(S))
DECAYS = {"decay": None, "log_a-20": 20.0, "slow": 1e-3}
SLOW = (1, 2048, 64)


def _inputs(seed, B, S, W, depth=None):
    """log_a = -|N(0, 0.5)| (the JAX tests' decays), or uniform in
    [-depth, 0]; x ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    if depth is None:
        la = -np.abs(rng.normal(size=(B, S, W)) * 0.5)
    else:
        la = -rng.uniform(0.0, depth, size=(B, S, W))
    return la.astype(np.float32), rng.normal(size=(B, S, W)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_fwd(seed, B, S, W, depth):
    """(log_a, x, the Pallas kernel in interpret mode, the oracle)."""
    la, x = _inputs(seed, B, S, W, depth)
    jh = ops.rglru_scan(jnp.asarray(la), jnp.asarray(x), interpret=True)
    rh = jref.rglru_reference(jnp.asarray(la), jnp.asarray(x))
    return la, x, np.asarray(jh), np.asarray(rh)


def _assert_scan_close(got, want, tol, slow, *, reverse=False, scale=None):
    """|got - want| <= tol (1 + |want|), or, for a slow decay, tol (1 +
    the scale the scan has carried: `scan_scale`, or `scale`)."""
    got, want = (torch.from_numpy(np.array(t, dtype=np.float64))
                 for t in (got, want))
    if slow:
        ref = scan_scale(want, reverse=reverse) if scale is None else scale
    else:
        ref = want.abs()
    err = (got - want).abs()
    worst = float((err / (1 + ref.double())).max()) / tol
    assert worst <= 1.0, f"error {worst:.3f} of the bar"


def _t(*arrs, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrs]


def _flatten(tree, path=()):
    """(key path, leaf) pairs of nested dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


def _rg_cfgs(**kw):
    """The JAX reduced recurrentgemma config in f32 and the port's copy."""
    jcfg = dataclasses.replace(reduced(JAX_RG, layers=5), dtype="float32",
                               **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("B,S,W,chunk,blk_w", RGLRU_CASES)
def test_plain_scan_matches_jax_kernel_and_oracle(B, S, W, chunk, blk_w):
    la, x = _inputs(1, B, S, W)
    jh = ops.rglru_scan(jnp.asarray(la), jnp.asarray(x), interpret=True)
    rh = jref.rglru_reference(jnp.asarray(la), jnp.asarray(x))
    before = rglru_scan.launches
    for fn in (rglru_sequential, rglru_scan, rglru_scan_fwd,
               rglru_reference):
        h = fn(*_t(la, x))
        for want in (jh, rh):
            np.testing.assert_allclose(h.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    assert rglru_scan.launches == before      # CPU tensors: no kernel


def test_reverse_mode_is_the_shifted_time_reversed_recurrence():
    """reverse: h_t = exp(log_a_{t+1}) h_{t+1} + x_t from t = S-1 down,
    i.e. the forward recurrence over flipped inputs with log_a shifted by
    one step."""
    la, x = _t(*_inputs(2, 2, 30, 6))
    got = rglru_sequential(la, x, reverse=True)
    shifted = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    want = rglru_reference(shifted.flip(1), x.flip(1)).flip(1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    assert torch.equal(rglru_scan_fwd(la, x, reverse=True), got)


@pytest.mark.parametrize("depth", [None, 20.0], ids=["decay", "log_a-20"])
def test_grads_match_jax(depth):
    """d/d(log_a, x) of (w * h).sum() through the port's Function (its
    reverse-recurrence backward) against the JAX package's custom_vjp
    (the VJP of its sequential oracle), with log_a -|N(0, 0.5)| and
    uniform in [-20, 0]."""
    la, x = _inputs(3, 2, 48, 8, depth)
    w = np.random.default_rng(4).normal(size=la.shape).astype(np.float32)
    jg = jax.grad(lambda a, b: (jnp.asarray(w) * ops.rglru_scan(
        a, b, interpret=True)).sum(), (0, 1))(jnp.asarray(la),
                                              jnp.asarray(x))
    ins = _t(la, x, grad=True)
    tg = torch.autograd.grad((torch.from_numpy(w) * rglru_scan(*ins)).sum(),
                             ins)
    for got, want in zip(tg, jg):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_GRAD, atol=TOL_GRAD)


@pytest.mark.parametrize("case", CHUNKED_CASES)
@pytest.mark.parametrize("decay", ["decay", "log_a-20"])
@pytest.mark.parametrize("chunk", [CHUNK, 16])
def test_chunked_matches_jax_kernel_and_oracle(case, decay, chunk):
    """The kernel's three passes in plain PyTorch against the JAX Pallas
    kernel (interpret) and its sequential oracle at the JAX bar, at the
    kernel's chunk of 64 and at 16 (many chunks at the JAX cases)."""
    la, x, jh, rh = _jax_fwd(10, *case, DECAYS[decay])
    h = rglru_chunked(*_t(la, x), chunk=chunk)
    for want in (jh, rh):
        np.testing.assert_allclose(h.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CHUNKED_CASES + [SLOW])
@pytest.mark.parametrize("decay", list(DECAYS))
def test_chunked_reverse_matches_the_sequential_reverse(case, decay):
    la, x = _t(*_inputs(11, *case, DECAYS[decay]))
    _assert_scan_close(rglru_chunked(la, x, reverse=True),
                       rglru_sequential(la, x, reverse=True), TOL,
                       decay == "slow", reverse=True)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_slow_decay_is_as_close_to_exact_as_the_oracle(reverse):
    """log_a in [-1e-3, 0] at S=2048: h carries O(sqrt(S)) values through
    zero, so no f32 order meets tol (1 + |h_t|) against another (the JAX
    kernel misses it against the exact float64 recurrence too). The
    chunked passes meet tol (1 + the carried scale) against the JAX
    kernel (forward) or the sequential reverse, and are at least as close
    to the exact recurrence as the sequential f32 oracle."""
    la_np, x_np, jh, _ = _jax_fwd(12, *SLOW, DECAYS["slow"])
    la, x = _t(la_np, x_np)
    got = rglru_chunked(la, x, reverse=reverse)
    oracle = rglru_sequential(la, x, reverse=True) if reverse else _t(jh)[0]
    _assert_scan_close(got, oracle, TOL, True, reverse=reverse)
    exact = rglru_sequential(la.double(), x.double(), reverse=reverse)
    scale = 1 + scan_scale(exact, reverse=reverse).double()

    def err(h):
        return float(((h.double() - exact).abs() / scale).max())

    assert err(got) <= err(oracle)
    assert float(((oracle.double() - exact).abs()
                  / (1 + exact.abs())).max()) > TOL


@pytest.mark.parametrize("case,decay", [((2, 300, 16), d) for d in DECAYS]
                         + [(SLOW, "slow")])
def test_fused_dlog_a_matches_the_jax_vjp(case, decay):
    """The fused backward's (dx, dlog_a) as `rglru_chunked` computes them
    from the forward's output, and the CPU backward `rglru_scan_bwd`,
    against jax.vjp of the JAX oracle at the gradient bar; for a slow
    decay relative to the carried scales (`scan_scale`,
    `dlog_a_scale`)."""
    la, x = _inputs(13, *case, DECAYS[decay])
    g = np.random.default_rng(14).normal(size=la.shape).astype(np.float32)
    h, vjp = jax.vjp(jref.rglru_reference, jnp.asarray(la), jnp.asarray(x))
    jdla, jdx = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tla, tg, th, tdx = _t(la, g, np.asarray(h), jdx)
    slow = decay == "slow"
    scale = dlog_a_scale(tdx, th)
    for dla, dx in (rglru_chunked(tla, tg, reverse=True, h=th)[::-1],
                    rglru_scan_bwd(tla, tg, th)):
        _assert_scan_close(dx, jdx, TOL_GRAD, slow, reverse=True)
        _assert_scan_close(dla, jdla, TOL_GRAD, slow, scale=scale)


def test_function_saves_log_a_and_its_output():
    """The Function saves log_a and h, not x: h is saved anyway by the
    gate product that follows."""
    la, x = _t(*_inputs(5, 1, 16, 4), grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        h = rglru_scan(la, x)
    assert len(saved) == 2 and saved[0] is la and saved[1] is h


def test_wrapper_refuses_bad_shapes():
    la, x = _t(*_inputs(6, 1, 16, 4))
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_fwd(la, x[:, :8])
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_fwd(la[0], x[0])


def test_gelu_tanh_saves_input_and_matches_jax():
    """The branch gate's GELU is jax.nn.gelu's default tanh form: forward
    and grad at 1e-5, saving its input only. The exact (erf) form of the
    MLP differs from it by more than the bar (1.5e-4 at x = 1)."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=60) * 2, [1.0]]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = layers.gelu_tanh(tx)
    assert len(saved) == 1 and saved[0] is tx
    (got,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    jy, jvjp = jax.vjp(jax.nn.gelu, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jvjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)
    exact = layers.gelu(tx).detach().numpy()
    assert abs(exact[-1] - y.detach().numpy()[-1]) > 1e-4


def test_matmul_f32_saves_the_weight_not_its_f32_copy():
    """x32 @ w.float() for a bf16 weight saves x32 and the bf16 weight
    (so the training engine sees a parameter, not a fresh W x W f32
    tensor); the grads are those of the composite, dw cast to bf16."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 5, 12)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(12, 12)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(2, 5, 12)).astype(np.float32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = layers.matmul_f32(x, w)
    assert len(saved) == 2 and saved[0] is x and saved[1] is w
    dx, dw = torch.autograd.grad(y, (x, w), g)
    yc = x @ w.float()
    dxc, dwc = torch.autograd.grad(yc, (x, w), g)
    assert torch.equal(y, yc) and dw.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.numpy(), dxc.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dw.float().numpy(), dwc.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_init_matches_the_jax_tree():
    """Same leaves and shapes as the JAX init, with b_a, b_i and lambda_p
    float32 in a bf16 model."""
    jcfg, tcfg = _rg_cfgs(rglru_width=40)
    jp = jrg.init_rglru(jax.random.key(0), jcfg, jnp.bfloat16)
    tp = rglru.init_rglru(torch.Generator().manual_seed(0), tcfg,
                          torch.bfloat16, lead=(3,))
    want = dict(_flatten(jax.tree.map(np.asarray, jp)))
    got = dict(_flatten(tp))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == (3,) + leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    assert tp["lambda_p"].dtype == torch.float32
    assert float(tp["lambda_p"][0, 0]) == 0.5


@pytest.mark.parametrize("jimpl,impl", [("xla", "torch"),
                                        ("pallas_interpret", "cuda")])
def test_apply_rglru_matches_jax(jimpl, impl):
    """The mixer on weights from the JAX init, float32: output, final h
    and conv state at 1e-4, and every gradient (weights and input) at
    the gradient bar; impl "cuda" takes the kernel wrapper, which runs
    the plain recurrence and its reverse on CPU tensors. Nonzero biases
    and a spread of lambda, so every leaf matters."""
    jcfg, tcfg = _rg_cfgs(rglru_width=40)
    jp = jrg.init_rglru(jax.random.key(1), jcfg, jnp.float32)
    rng = np.random.default_rng(9)
    jp = dict(jp, b_a=jnp.asarray(rng.normal(size=40) * 0.3, jnp.float32),
              b_i=jnp.asarray(rng.normal(size=40) * 0.3, jnp.float32),
              lambda_p=jnp.asarray(rng.normal(size=40), jnp.float32))
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)

    def jf(p, x):
        y, c = jrg.apply_rglru(p, x, jcfg, impl=jimpl)
        return (y * jnp.asarray(g)).sum(), (y, c)

    (_, (jy, jc)), jgr = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    flat = list(_flatten(tp))
    for _, t in flat:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tc = rglru.apply_rglru(tp, tx, tcfg, impl=impl)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["h"].detach().numpy(),
                               np.asarray(jc["h"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["conv"].detach().numpy(),
                               np.asarray(jc["conv"]), rtol=1e-5, atol=1e-5)
    tg = torch.autograd.grad(ty, [t for _, t in flat] + [tx],
                             torch.from_numpy(g))
    jgp, jgx = jgr
    for (path, _), got in zip(flat, tg):
        want = jgp
        for k in path:
            want = want[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=str(path))
    np.testing.assert_allclose(tg[-1].numpy(), np.asarray(jgx),
                               rtol=TOL_GRAD, atol=TOL_GRAD)
    with pytest.raises(ValueError, match="unknown rglru impl"):
        rglru.apply_rglru(tp, tx, tcfg, impl="pallas")
