"""Card-only tests of the port: the hand-written CUDA kernels (flash
attention in f32 and on the bf16 tensor cores, at head_dim 256 too and
non-causal at BERT's shapes; SSD scan, its four passes; RG-LRU scan, its
three passes, both modes and the fused backward, and the same bits on a
repeat call) against their plain PyTorch versions, the Python mirrors of
their launch arithmetic against the libraries, the serve path through
the flash kernel, and training through the kernels (GPT, BERT, T5,
mamba2, the hybrid). A CUDA kernel has no CPU mode, so without a card these
skip; on the card run
`PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`. This
file imports no jax (the card's machine has none)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (MAMBA2_2_7B, RECURRENTGEMMA_9B,
                                 SpoolIoConfig)
from repro_torch.configs.paper_models import small_bert, small_gpt, small_t5
from repro_torch.core.policies import KeepPolicy, SpoolPolicy
from repro_torch.core.tree import tree_flatten
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_reference, rglru_reference
from repro_torch.kernels.rglru_scan import (dlog_a_scale, rglru_scan,
                                            rglru_scan_bwd, rglru_scan_fwd,
                                            rglru_sequential, scan_scale)
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan, ssd_scan_fwd
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.models.transformer import RunSettings
from repro_torch.session import TrainSession
from test_torch_plans import ATTN_CASES as PLAN_ATTN_CASES
from test_torch_plans import RGLRU_CASES as PLAN_RGLRU_CASES
from test_torch_plans import SSD_CASES as PLAN_SSD_CASES
from torch_one_thread import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): tests/test_kernels.py
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (2, 64, 64, 4, 1, 32, True, 0, 0.0),
    (1, 128, 128, 2, 2, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),
    (1, 96, 96, 2, 2, 32, True, 0, 0.0),
    (1, 16, 16, 2, 2, 128, True, 0, 0.0),
]
SERVE_CASES = [(1, S, S, 64, 64, 128, True, 0, 0.0) for S in (1000, 1024)]
# (B, S, H, P, N, chunk): tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (2, 96, 2, 16, 8, 32),
]
# mamba2-2.7b's training shape: B and C are column slices of the conv
# output (strided views), decays of full-width size
MAMBA2_SSD = (1, 1024, 80, 64, 128, 128)
SMALL_MAMBA2 = dataclasses.replace(
    MAMBA2_2_7B, num_layers=2, d_model=128, ssm_state_dim=32,
    ssm_head_dim=32, ssm_chunk=32, vocab_size=1024, max_position=256)
# recurrentgemma cut to both segments (rglru, rglru, attn) + (rglru,
# rglru), keeping MQA at head_dim 256; S=128 > window 64
SMALL_HYBRID = dataclasses.replace(
    RECURRENTGEMMA_9B, num_layers=5, d_model=128, num_heads=2,
    num_kv_heads=1, head_dim=256, d_ff=256, vocab_size=1024,
    rglru_width=128, sliding_window=64)
# recurrentgemma-9b's attention: (B, S, Hq, Hkv, D, causal, window)
D256_CASES = [(1, 2048, 16, 1, 256, True, 2048),
              (1, 4096, 16, 1, 256, True, 2048),
              (1, 100, 4, 1, 256, True, 0)]
# (B, S, W, log_a uniform depth or None for -|N(0, 0.5)|):
# tests/test_kernels.py::RGLRU_CASES, the recurrentgemma-9b shape, log_a
# down to -20, S ragged over chunks of 64 and shorter than one, and the
# slow decay of trained gates (uniform in [-1e-3, 0]) at the path shape
SLOW = 1e-3
RGLRU_CASES = [(1, 64, 16, None), (2, 128, 32, None), (1, 100, 8, None),
               (1, 2048, 4096, None), (1, 256, 64, 20.0),
               (1, 300, 40, None), (2, 40, 8, None), (1, 2048, 4096, SLOW)]


# bf16 attention against the f32 reference: 2^-6 of the largest |output|
# of each row (chip_smoke.TOL_BF16_ROW: the output's bf16 rounding plus the
# tensor-core kernel's bf16 P; the CUDA source's header note)
TOL_BF16_ROW = 2 ** -6


def assert_attention_close(out, want, tol):
    """f32: `tol` abs + rel per element; bf16: `tol` of each row's
    largest |output|."""
    if out.dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   rtol=tol, atol=tol)
        return
    d = (out.float() - want).abs()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    worst = (d / rowmax.clamp_min(1e-30)).max().item()
    assert bool((d <= tol * rowmax).all()), (
        f"error {worst:.3e} of a row's largest output > {tol:g}")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case,dtype,tol",
                         [(c, torch.float32, 2e-5) for c in ATTN_CASES]
                         + [(c, torch.bfloat16, TOL_BF16_ROW)
                            for c in SERVE_CASES]
                         + [(c, torch.bfloat16, TOL_BF16_ROW)
                            for c in ATTN_CASES])
def test_kernel_matches_plain(card, case, dtype, tol):
    """f32 cases run the FMA kernel, bf16 ones the tensor-core kernel:
    every mask, softcap, GQA/MQA and ragged-length case in both."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(card, dtype) for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                          (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attention_reference(q.float(), k.float(), v.float(), **kw)
    assert_attention_close(out, want, tol)


# BERT's bidirectional attention at the paper's widths (64, 96 and 128
# heads of 128, S=1024): every kv tile of every query block is live, and
# only padded keys are masked
BERT_CASES = [(1, 1024, 1024, H, H, 128, False, 0, 0.0) for H in (64, 96,
                                                                   128)]
# cross-attention: Sq decoder queries against Skv encoder keys
CROSS_CASES = [(2, 128, 96, 4, 4, 64, False, 0, 0.0),
               (1, 100, 300, 4, 4, 128, False, 0, 0.0)]


@pytest.mark.parametrize("case,dtype,tol",
                         [(c, torch.bfloat16, TOL_BF16_ROW)
                          for c in BERT_CASES]
                         + [((1, 1024, 1024, 8, 8, 128, False, 0, 0.0),
                             torch.float32, 2e-5),
                            ((2, 1000, 1000, 4, 4, 128, False, 0, 0.0),
                             torch.bfloat16, TOL_BF16_ROW)]
                         + [(c, dt, tol) for c in CROSS_CASES
                            for dt, tol in ((torch.bfloat16, TOL_BF16_ROW),
                                            (torch.float32, 2e-5))])
def test_flash_noncausal_matches_plain(card, case, dtype, tol):
    """The non-causal path over many kv tiles: the tensor-core kernel at
    BERT's shapes, the FMA kernel in f32, a ragged length, and T5's
    cross-attention with encoder states longer or shorter than the
    decoder's queries."""
    test_kernel_matches_plain(card, case, dtype, tol)


@pytest.mark.parametrize("case", D256_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL_BF16_ROW),
                                       (torch.float32, 2e-5)])
def test_flash_head_dim_256_matches_plain(card, case, dtype, tol):
    """head_dim 256 (two threads per query row in the kernel), MQA, with
    and without a window that masks, at the attention bars."""
    B, S, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(card, dtype) for s in ((B, S, Hq, D), (B, S, Hkv, D),
                                          (B, S, Hkv, D)))
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_reference(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    assert_attention_close(out, want, tol)


def _rglru_inputs(card, B, S, W, depth, seed=11):
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.normal(size=(B, S, W)) * 0.5) if depth is None
          else -rng.uniform(0, depth, size=(B, S, W)))
    x = rng.normal(size=(B, S, W))
    return (torch.from_numpy(a.astype(np.float32)).to(card) for a in (la, x))


def assert_scan_close(got, want, tol, scale=None):
    """|got - want| <= tol (1 + |want|), or tol (1 + scale) given one."""
    ref = want.double().abs() if scale is None else scale.double()
    worst = float(((got.double() - want.double()).abs() / (1 + ref)).max())
    assert worst <= tol, f"error {worst / tol:.3f} of the bar"


@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_rglru_kernel_matches_plain(card, case, reverse):
    """Both modes against the plain recurrence at the JAX bar (1e-5); a
    slow decay against the exact (f64) recurrence at 1e-5 of the scale
    the scan has carried (the f32 sequential order misses that bar
    itself on the card; no f32 order meets the elementwise one, as the
    CPU tests show)."""
    la, x = _rglru_inputs(card, *case)
    before = rglru_scan.launches
    h = rglru_scan_fwd(la, x, reverse=reverse)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    if case[3] == SLOW:
        want = rglru_sequential(la.double(), x.double(), reverse=reverse)
        assert_scan_close(h, want, 1e-5, scan_scale(want, reverse=reverse))
    else:
        assert_scan_close(h, rglru_sequential(la, x, reverse=reverse), 1e-5)


@pytest.mark.parametrize("case", [(1, 2048, 4096, None),
                                  (1, 2048, 4096, SLOW),
                                  (2, 300, 96, 20.0)])
def test_rglru_fused_backward_matches_the_plain_vjp(card, case):
    """The fused backward (reverse mode with dlog_a in its rescan), one
    launch of the wrapper, against autograd through the plain recurrence
    at the gradient bar (5e-4); a slow decay against autograd of the
    exact (f64) recurrence relative to the carried scales
    (`scan_scale`, `dlog_a_scale`)."""
    la, x = _rglru_inputs(card, *case)
    g = torch.randn(la.shape, device=card,
                    generator=torch.Generator(device=card).manual_seed(3))
    h = rglru_scan_fwd(la, x)
    before = rglru_scan.launches
    dla, dx = rglru_scan_bwd(la, g, h)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    slow = case[3] == SLOW
    dt = torch.float64 if slow else torch.float32
    la_, x_ = (t.to(dt).requires_grad_(True) for t in (la, x))
    h_ = rglru_sequential(la_, x_)
    wla, wx = torch.autograd.grad(h_, (la_, x_), g.to(dt))
    assert_scan_close(dx, wx, 5e-4,
                      scan_scale(wx, reverse=True) if slow else None)
    assert_scan_close(dla, wla, 5e-4,
                      dlog_a_scale(wx, h_.detach()) if slow else None)


def test_rglru_kernel_gives_the_same_bits_twice(card):
    """No atomics and a fixed order of every sum: a repeat call of each
    mode and of the fused backward gives the same bits (keep = spool
    parity rests on it)."""
    for case in ((1, 2048, 4096, None), (2, 300, 40, SLOW)):
        la, x = _rglru_inputs(card, *case)
        h = rglru_scan_fwd(la, x)
        for fn in (lambda: (rglru_scan_fwd(la, x),),
                   lambda: (rglru_scan_fwd(la, x, reverse=True),),
                   lambda: rglru_scan_bwd(la, x, h)):
            first = [t.clone() for t in fn()]
            assert all(torch.equal(a, b) for a, b in zip(first, fn()))


@pytest.mark.parametrize("case", PLAN_RGLRU_CASES)
def test_rglru_plan_matches_the_library(card, case):
    """`rglru_plan`, which the CPU tests check, against the built
    library's chunk, grids, threads and scratch bytes."""
    plan = rg.rglru_plan(*case)
    del plan["scratch"]
    assert plan == rg.library_plan(*case)


def test_rglru_kernel_grads_match_the_oracle(card):
    """Forward and backward (the reverse mode) through the Function
    against autograd of the sequential oracle, at the gradient bar."""
    la, x = _rglru_inputs(card, 2, 300, 96, 20.0)
    la.requires_grad_(True)
    x.requires_grad_(True)
    g = torch.randn_like(x)
    before = rglru_scan.launches
    got = torch.autograd.grad(rglru_scan(la, x), (la, x), g)
    assert rglru_scan.launches == before + 2
    want = torch.autograd.grad(rglru_reference(la, x), (la, x), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=5e-4)


def test_rglru_kernel_reads_strides_and_refuses_the_rest(card):
    """Batch and time strides are read as given (views of a wider
    tensor); a strided last dimension and other dtypes are refused."""
    big = torch.randn((2, 64, 3, 40), device=card)
    big[:, :, 0] = -big[:, :, 0].abs()
    la, x = big[:, :, 0], big[:, :, 1]
    assert not la.is_contiguous() and not x.is_contiguous()
    h = rglru_scan_fwd(la, x)
    np.testing.assert_allclose(h.cpu().numpy(),
                               rglru_sequential(la, x).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_fwd(big[..., 0].transpose(1, 2), big[..., 1].transpose(
            1, 2))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan_fwd(la.bfloat16(), x.bfloat16())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mirrors_match_the_library(card, dtype):
    """`flash_plan`, `kv_tiles` and `warp_live`, which the CPU tests check
    (tests/test_torch_plans.py), against the built library's own numbers
    at every instance and at every q tile and warp of the plan cases."""
    for D in fa.HEAD_DIMS:
        assert fa.flash_plan(D, dtype) == fa.library_plan(D, dtype)
    for B, Sq, Skv, Hq, Hkv, D, causal, window, cap in PLAN_ATTN_CASES:
        plan = fa.flash_plan(D, dtype)
        bq, bk = plan["bq"], plan["bk"]
        for q0 in range(0, Sq, bq):
            tiles = fa.kv_tiles(q0, bq, bk, Sq, Skv, causal, window)
            assert tiles == fa.library_kv_tiles(D, dtype, q0, Sq, Skv,
                                                causal, window)
            if dtype == torch.bfloat16:
                assert [fa.warp_live(t * bk, r, bk, Sq, causal, window)
                        for t in tiles for r in range(q0, q0 + bq, 16)] == [
                    fa.library_warp_live(D, t * bk, r, Sq, causal, window)
                    for t in tiles for r in range(q0, q0 + bq, 16)]


@pytest.mark.parametrize("case", PLAN_SSD_CASES)
def test_ssd_plan_matches_the_library(card, case):
    """`ssd_plan`'s passes, which the CPU tests check, against the built
    library's own grids, threads and shared memory."""
    B, S, H, P, N, chunk = case
    Q = ssd.pick_chunk(S, chunk)
    assert ssd.ssd_plan(B, S, H, P, N, Q)["passes"] == ssd.library_plan(
        B, S, H, P, N, Q)


def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 48), device=card)           # D=48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q)


def test_kernel_refuses_a_misaligned_view(card):
    """The bf16 kernel copies 16-byte rows: a view 2 bytes into its
    storage is refused, with no fallback; a 16-byte offset is taken."""
    base = torch.randn((1, 64, 2, 80), device=card).bfloat16()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(base[..., 1:65], base[..., 1:65], base[..., 1:65])
    q = base[..., 8:72]
    before = flash_attention.launches
    out = flash_attention(q, q, q)
    assert flash_attention.launches == before + 1
    want = attention_reference(q.float(), q.float(), q.float())
    assert_attention_close(out, want, TOL_BF16_ROW)


def test_serve_through_the_kernel_paged_equals_dense(card, tmp_path):
    """small-gpt (bf16) served on the card: prefills go through the
    kernel once per layer, and paged (with eviction to an fs spool) and
    dense logits are bitwise equal."""
    argv = ["--arch", "small-gpt", "--device", "cuda", "--requests", "6",
            "--batch", "2", "--prompt-len", "40", "--max-new", "6",
            "--cache-len", "48", "--page-tokens", "8", "--quantum", "2",
            "--kv-backend", "fs", "--kv-dir", str(tmp_path)]
    rt = serve.build_runtime("small-gpt", seed=0, device="cuda")
    before = flash_attention.launches
    sp, rp = serve.run(serve.parse_args(argv), rt, record_logits=True)
    assert flash_attention.launches - before == rp.kv["prefills"] * 4
    sd, _ = serve.run(serve.parse_args(argv + ["--cache", "dense"]), rt,
                      record_logits=True)
    assert rp.preemptions > 0
    assert rp.kv["pages_evicted"] == rp.kv["pages_restored"] > 0
    p = {s.rid: s for s in sp.finished}
    d = {s.rid: s for s in sd.finished}
    assert set(p) == set(d) and len(p) == 6
    for rid in p:
        assert p[rid].tokens == d[rid].tokens
        for a, b in zip(p[rid].logits, d[rid].logits):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", SSD_CASES + [MAMBA2_SSD])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(card, case, dtype):
    """f32 at the JAX bar (2e-4); bf16 B/C: both versions read the same
    bf16 values and sum in f32, so the same bar holds. The mamba2-2.7b
    shape (strided B/C, full-width decays): 1e-5 of the output's scale,
    as in chip_smoke.py, since only the order of the f32 sums differs."""
    B, S, H, P, N, chunk = case
    rng = np.random.default_rng(7)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(card)

    xh = t((B, S, H, P))
    if case == MAMBA2_SSD:
        a = -torch.nn.functional.softplus(t((B, S, H)))
        conv = t((B, S, 5376)).to(dtype)
        Bs, Cs = conv[..., 5120:5248], conv[..., 5248:]
        assert not Bs.is_contiguous()
    else:
        a = -t((B, S, H), 0.2).abs()
        Bs, Cs = t((B, S, N)).to(dtype), t((B, S, N)).to(dtype)
    before = ssd_scan.launches
    y, st = ssd_scan_fwd(xh, a, Bs, Cs, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, sr = ssd_chunked(xh, a, Bs, Cs, chunk)
    for got, want in ((y, yr), (st, sr)):
        if case == MAMBA2_SSD:
            scale = float(yr.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale
        else:
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=2e-4,
                                       atol=2e-4)


def test_ssd_kernel_rejects_what_it_does_not_take(card):
    xh = torch.zeros((1, 512, 2, 16), device=card)
    a = torch.zeros((1, 512, 2), device=card)
    bc = torch.zeros((1, 512, 8), device=card)
    with pytest.raises(ValueError, match="does not fit"):
        ssd_scan_fwd(xh, a, bc, bc, chunk=256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_scan_fwd(xh, a, bc.half(), bc.half(), chunk=64)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan_fwd(xh.bfloat16(), a, bc, bc, chunk=64)


def test_flash_attention_carries_gradient(card):
    """The kernel's autograd Function: grads equal the plain reference's
    VJP (the same computation, so f32 to 2e-4)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 4, 32)).astype(
        np.float32)).to(card).requires_grad_(True) for _ in range(3))
    g = torch.from_numpy(rng.normal(size=(1, 64, 4, 32)).astype(
        np.float32)).to(card)
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(attention_reference(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cfg", [small_gpt(128, 2), SMALL_MAMBA2,
                                 SMALL_HYBRID, small_bert(128, 2),
                                 small_t5(128, 4)],
                         ids=["small-gpt", "mamba2", "hybrid", "small-bert",
                              "small-t5"])
def test_loss_and_grads_through_kernels_match_plain(card, cfg):
    """bf16 models: loss and every gradient leaf through the kernels
    (attn_impl="cuda") against the plain paths. They differ by bf16
    roundings at other places, so the bar is relative to each leaf's
    scale: 5e-2 of max |grad|. T5's encoder input is shorter than the
    decoder's, so its cross-attention has Skv != Sq."""
    api = build_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129))).to(
        card)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_tokens"] = toks[:, :96]
    out = {}
    for impl in ("cuda", "torch"):
        st = RunSettings(attn_impl=impl, attn_chunk=64,
                         param_dtype=cfg.dtype, device="cuda")
        before = (flash_attention.launches, ssd_scan.launches,
                  rglru_scan.launches)
        loss, _ = api.loss(params, batch, st)
        out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        if impl == "cuda":
            assert (flash_attention.launches, ssd_scan.launches,
                    rglru_scan.launches) != before
    assert abs(out["cuda"][0] - out["torch"][0]) < 2e-2
    for a, b in zip(out["cuda"][1], out["torch"][1]):
        assert bool(torch.isfinite(a).all())
        scale = float(b.float().abs().max()) or 1.0
        assert float((a.float() - b.float()).abs().max()) <= 5e-2 * scale


def test_keep_vs_spool_bitwise_on_card(card, tmp_path):
    """A small bf16 mamba2 trained through the SSD kernel, residuals kept
    on the card vs spooled to a directory: losses and params bitwise."""
    runs = {}
    for name, policy, io in (
            ("keep", KeepPolicy(), None),
            ("spool", SpoolPolicy(), SpoolIoConfig(
                backend="fs", directory=str(tmp_path)))):
        with TrainSession(SMALL_MAMBA2, policy=policy, io=io,
                          optimizer="adamw", batch_size=2, seq_len=128,
                          device="cuda", min_offload_elements=1024) as s:
            before = ssd_scan.launches
            res = s.run(2)
            assert ssd_scan.launches - before == 2 * 2
            runs[name] = (res.losses, [t.detach().cpu() for t in
                                       tree_flatten(res.params)[0]],
                          res.reports)
    assert runs["keep"][0] == runs["spool"][0]
    for a, b in zip(runs["keep"][1], runs["spool"][1]):
        assert torch.equal(a, b)
    assert all(r.extra["stages_offloaded"] == r.extra["stages_fetched"] == 4
               for r in runs["spool"][2])
    assert list(tmp_path.iterdir()) == []


def test_hybrid_keep_vs_spool_bitwise_on_card(card, tmp_path):
    """A small bf16 hybrid trained through the RG-LRU and flash kernels
    with sgd, kept vs spooled to a directory: losses and params bitwise,
    the RG-LRU kernel once per rglru block per step each way, every one
    of the 4 stages stored and fetched."""
    runs = {}
    for name, policy, io in (
            ("keep", KeepPolicy(), None),
            ("spool", SpoolPolicy(), SpoolIoConfig(
                backend="fs", directory=str(tmp_path)))):
        with TrainSession(SMALL_HYBRID, policy=policy, io=io,
                          optimizer="sgd", batch_size=2, seq_len=128,
                          device="cuda", min_offload_elements=1024) as s:
            before = (rglru_scan.launches, flash_attention.launches)
            res = s.run(2)
            assert (rglru_scan.launches - before[0],
                    flash_attention.launches - before[1]) == (2 * 4 * 2, 2)
            runs[name] = (res.losses, [t.detach().cpu() for t in
                                       tree_flatten(res.params)[0]],
                          res.reports)
    assert runs["keep"][0] == runs["spool"][0]
    for a, b in zip(runs["keep"][1], runs["spool"][1]):
        assert torch.equal(a, b)
    assert all(r.extra["stages_offloaded"] == r.extra["stages_fetched"] == 4
               for r in runs["spool"][2])
    assert list(tmp_path.iterdir()) == []
