"""The port's Mamba-2 SSD scan against the JAX package: the plain chunked
version (`kernels/ssd_scan.py::ssd_chunked`, which the `ssd_scan`
wrapper runs on CPU tensors) against JAX's Pallas kernel in interpret
mode and its sequential oracle, the exact sequential `ssd_reference`
against JAX's, gradients through the `ssd_scan` autograd Function
against JAX's `ops.ssd_scan` VJP, the depthwise conv1d Function, and
the Mamba-2 mixer `apply_mamba2` on JAX weights. Inputs come from numpy
seeds; the CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.mamba2_2_7b import CONFIG as JAX_MAMBA2  # noqa: E402
from repro.kernels import ops, ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.configs import MAMBA2_2_7B  # noqa: E402
from repro_torch.kernels.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import (pick_chunk, ssd_chunked,  # noqa
                                          ssd_scan, ssd_scan_fwd)
from repro_torch.models import layers, mamba2  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

# (B, S, H, P, N, chunk): tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (2, 96, 2, 16, 8, 32),
]
TOL = 2e-4           # the JAX package's forward bar for the SSD kernel
TOL_GRAD = 5e-4      # and its gradient bar


def _inputs(seed, B, S, H, P, N, decay=0.2):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = -np.abs(rng.normal(size=(B, S, H)) * decay).astype(np.float32)
    Bs = rng.normal(size=(B, S, N)).astype(np.float32)
    Cs = rng.normal(size=(B, S, N)).astype(np.float32)
    return xh, a, Bs, Cs


def _t(*arrs, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrs]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_plain_scan_matches_jax_kernel_and_oracle(B, S, H, P, N, chunk):
    arrs = _inputs(1, B, S, H, P, N)
    jy, js = ops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                          interpret=True)
    ry, rs = jref.ssd_reference(*map(jnp.asarray, arrs))
    before = ssd_scan.launches
    for fn in (lambda *a: ssd_chunked(*a, chunk),
               lambda *a: ssd_scan(*a, chunk=chunk),
               lambda *a: ssd_scan_fwd(*a, chunk=chunk)):
        y, st = fn(*_t(*arrs))
        for got, want in ((y, jy), (st, js), (y, ry), (st, rs)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=TOL, atol=TOL)
    assert ssd_scan.launches == before      # CPU tensors: no kernel
    assert pick_chunk(96, 32) == 32 and pick_chunk(96, 64) == 32


def test_sequential_reference_matches_jax():
    arrs = _inputs(2, 2, 40, 2, 8, 4)
    y, st = ssd_reference(*_t(*arrs))
    jy, js = jref.ssd_reference(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_grads_match_jax():
    """d/d(xh, dA_log, B_s, C_s) of y.sum() + (w * state).sum() through
    the port's autograd Function (the plain chunked VJP) against the JAX
    package's custom_vjp (the VJP of its sequential oracle)."""
    arrs = _inputs(3, 1, 64, 2, 8, 4)
    w = np.random.default_rng(4).normal(size=(1, 2, 8, 4)).astype(
        np.float32)

    def jloss(*a):
        y, st = ops.ssd_scan(*a, chunk=16, interpret=True)
        return y.sum() + (jnp.asarray(w) * st).sum()

    jg = jax.grad(jloss, (0, 1, 2, 3))(*map(jnp.asarray, arrs))
    ins = _t(*arrs, grad=True)
    y, st = ssd_scan(*ins, chunk=16)
    tg = torch.autograd.grad(y.sum() + (torch.from_numpy(w) * st).sum(),
                             ins)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_GRAD, atol=TOL_GRAD)


def test_full_width_decays_give_finite_grads():
    """Decays of full-width size (dt ~ softplus ~ 0.7 with A = -1) over a
    128-step chunk: above the diagonal La_i - La_j passes 88 and exp
    overflows. The exponent is masked before the exp, so the chunked
    VJP stays finite and equal to the sequential recurrence's."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 1, 256, 2, 8, 8
    xh, _, Bs, Cs = _inputs(5, B, S, H, P, N)
    a = -np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    assert -a[0, :128].sum(0).min() > 88          # exp would overflow
    ins = _t(xh, a, Bs, Cs, grad=True)
    y, st = ssd_scan(*ins, chunk=128)
    g = torch.autograd.grad(y.sum() + st.sum(), ins)
    ref_ins = _t(xh, a, Bs, Cs, grad=True)
    yr, sr = ssd_reference(*ref_ins)
    gr = torch.autograd.grad(yr.sum() + sr.sum(), ref_ins)
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               rtol=TOL, atol=TOL)
    for got, want in zip(g, gr):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=TOL_GRAD, atol=TOL_GRAD)


def test_wrapper_refuses_bad_shapes():
    xh, a, Bs, Cs = _t(*_inputs(6, 1, 32, 2, 8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ssd_scan_fwd(xh, a[:, :16], Bs, Cs)
    with pytest.raises(ValueError, match="ssd_scan takes"):
        ssd_scan_fwd(xh[0], a, Bs, Cs)


def test_conv1d_matches_jax():
    """The depthwise causal conv Function (saves x and w only): forward,
    decode state and grads against the JAX composite."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    g = rng.normal(size=(2, 10, 6)).astype(np.float32)

    def jf(x, w, b):
        y, st = jlayers.apply_conv1d({"w": w, "b": b}, x)
        return (y * jnp.asarray(g)).sum(), (y, st)

    (_, (jy, jst)), jgr = jax.value_and_grad(jf, (0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = _t(x, w, b, grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y, st = layers.apply_conv1d({"w": tw, "b": tb}, tx)
    assert len(saved) == 2
    tgr = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(jst))
    for got, want in zip(tgr, jgr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_apply_mamba2_matches_jax(impl):
    """The mixer on weights from the JAX init, float32, at 1e-4; impl
    "cuda" takes the kernel wrapper, which runs the plain version on CPU
    tensors. Its final state and conv state too."""
    cfg = dataclasses.replace(JAX_MAMBA2, d_model=64, ssm_state_dim=16,
                              ssm_head_dim=16, ssm_chunk=16, dtype="float32")
    tcfg = dataclasses.replace(MAMBA2_2_7B, d_model=64, ssm_state_dim=16,
                               ssm_head_dim=16, ssm_chunk=16,
                               dtype="float32")
    jp = jm2.init_mamba2(jax.random.key(1), cfg, jnp.float32)
    # nonzero A_log / dt_bias / norm scale, so every leaf matters
    jp = dict(jp, A_log=jp["A_log"] + 0.3, dt_bias=jp["dt_bias"] - 0.5,
              norm_scale=jp["norm_scale"] + 0.1)
    x = np.random.default_rng(8).normal(size=(2, 48, 64)).astype(np.float32)
    jy, jc = jm2.apply_mamba2(jp, jnp.asarray(x), cfg, impl="xla")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ty, tc = mamba2.apply_mamba2(tp, torch.from_numpy(x), tcfg, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                               rtol=1e-5, atol=1e-5)
    assert mamba2.ssm_dims(tcfg) == tuple(jm2.ssm_dims(cfg))
    with pytest.raises(ValueError, match="unknown ssm impl"):
        mamba2.apply_mamba2(tp, torch.from_numpy(x), tcfg, impl="pallas")
