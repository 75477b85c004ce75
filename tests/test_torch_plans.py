"""The launch arithmetic around the port's flash-attention, SSD-scan and
RG-LRU kernels, in the Python mirrors that the wrappers keep of the `.cu`
constants (`flash_attention.flash_plan`, `kv_tiles`, `warp_live`;
`ssd_scan.ssd_plan`; `rglru_scan.rglru_plan`; on the card,
tests/test_torch_cuda.py and
chip_smoke.py hold them against the built libraries' own numbers), the
wrappers' refusals, which are metadata checks and run on CPU tensors,
and the bar of the card's bf16 attention checks against an emulation of
the tensor-core kernel's roundings. The kernels themselves run only on
the card (tests/test_torch_cuda.py). Each test takes every attention,
SSD or RG-LRU case of the JAX package's kernel tests plus the shapes of
the main paths: the serve prefill, recurrentgemma-9b's head_dim 256 and
RG-LRU scan, and mamba2-2.7b's scan."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.build import SMEM_LIMIT
from torch_one_thread import one_torch_thread  # noqa: E402,F401

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): tests/test_kernels.py,
# the serve prefill (S 1024 and a ragged 1000), recurrentgemma-9b's MQA at
# head_dim 256 (window 2048 at S=2048, and at S=4096 where it masks)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (2, 64, 64, 4, 1, 32, True, 0, 0.0),
    (1, 128, 128, 2, 2, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),
    (1, 96, 96, 2, 2, 32, True, 0, 0.0),
    (1, 16, 16, 2, 2, 128, True, 0, 0.0),
    (1, 1024, 1024, 64, 64, 128, True, 0, 0.0),
    (1, 1000, 1000, 64, 64, 128, True, 0, 0.0),
    (1, 2048, 2048, 16, 1, 256, True, 2048, 0.0),
    (1, 4096, 4096, 16, 1, 256, True, 2048, 0.0),
]
# (B, S, H, P, N, chunk): tests/test_kernels.py::SSD_CASES and the
# mamba2-2.7b training shape
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (2, 96, 2, 16, 8, 32),
    (1, 1024, 80, 64, 128, 128),
]
SM_SMEM = 233472     # shared memory of one SM; each block reserves 1 KB
# (B, S, W): tests/test_kernels.py::RGLRU_CASES, a ragged S, S shorter
# than a chunk, a width that is no multiple of the block, and the
# recurrentgemma-9b shape
RGLRU_CASES = [(1, 64, 16), (2, 128, 32), (1, 100, 8), (1, 300, 8),
               (2, 40, 8), (3, 129, 200), (1, 2048, 4096)]


def _mask(Sq, Skv, causal, window):
    """The attention masks as `ref.attention_reference` builds them."""
    iq = torch.arange(Sq)[:, None]
    jk = torch.arange(Skv)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        m &= jk <= iq
    if window:
        m &= jk > iq - window
    return m


def _tiles_needed(mask, rows, bk):
    """(row groups of `rows`, kv tiles of `bk`): whether the group holds
    an unmasked (row, col) pair in the tile (padded rows and keys are
    masked)."""
    Sq, Skv = mask.shape
    R, K = -(-Sq // rows) * rows, -(-Skv // bk) * bk
    m = torch.zeros((R, K), dtype=torch.bool)
    m[:Sq, :Skv] = mask
    return m.reshape(R // rows, rows, K // bk, bk).any(dim=3).any(dim=1)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_visits_every_tile_with_an_unmasked_pair(case, dtype):
    """Per q tile, the kv tiles the block loads, and (bf16 kernel) the
    tiles each warp of 16 rows multiplies, cover every unmasked pair of
    the causal / window / padded masks; the first and last tile the block
    loads each hold one, so no whole tile is loaded in vain at its ends."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    plan = fa.flash_plan(D, dtype)
    bq, bk = plan["bq"], plan["bk"]
    rows = 16 if dtype == torch.bfloat16 else bq
    mask = _mask(Sq, Skv, causal, window)
    need = _tiles_needed(mask, rows, bk)
    block_need = _tiles_needed(mask, bq, bk)
    seen = torch.zeros_like(need)
    for q0 in range(0, Sq, bq):
        tiles = fa.kv_tiles(q0, bq, bk, Sq, Skv, causal, window)
        assert len(tiles) > 0
        assert block_need[q0 // bq, tiles[0]]
        assert block_need[q0 // bq, tiles[-1]]
        for t in tiles:
            for r_lo in range(q0, min(q0 + bq, -(-Sq // rows) * rows), rows):
                if rows == bq or fa.warp_live(t * bk, r_lo, bk, Sq, causal,
                                              window):
                    seen[r_lo // rows, t] = True
    assert not (need & ~seen).any(), "a tile with an unmasked pair skipped"
    if rows == 16:      # and a warp runs no tile without one
        assert not (seen & ~need).any()


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_plan_fits_the_card(D, dtype):
    plan = fa.flash_plan(D, dtype)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    if dtype == torch.bfloat16:
        # one warp per 16 query rows, 16-key mma steps, double-buffered
        # K / V tiles of bk rows and the Q tile, rows padded by 16 bytes
        assert plan["threads"] == plan["bq"] // 16 * 32
        assert plan["bk"] % 16 == 0
        assert plan["smem"] == 2 * (D + 8) * (plan["bq"] + 4 * plan["bk"])


def test_flash_refuses_misaligned_and_unsupported_views():
    base = torch.zeros((1, 8, 2, 80), dtype=torch.bfloat16)
    q = base[..., 8:72]                        # 16-byte offset: taken
    fa.check_kernel_inputs(q, q, q)
    bad = base[..., 1:65]                      # 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_kernel_inputs(bad, bad, bad)
    odd = torch.zeros((1, 8, 3, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):   # stride 68
        fa.check_kernel_inputs(q, odd, odd)
    f32 = torch.zeros((1, 8, 2, 65))[..., 1:]  # f32 keeps the FMA kernel
    fa.check_kernel_inputs(f32, f32, f32)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
        fa.check_kernel_inputs(z, z, z)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        z = torch.zeros((1, 8, 2, 32), dtype=torch.float16)
        fa.check_kernel_inputs(z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros((1, 8, 32, 2), dtype=torch.bfloat16).transpose(2, 3)
        fa.check_kernel_inputs(z, z, z)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plan_grids_scratch_and_shared_memory(case):
    B, S, H, P, N, chunk = case
    Q = ssd.pick_chunk(S, chunk)
    nc = S // Q
    plan = ssd.ssd_plan(B, S, H, P, N, Q)
    passes = plan["passes"]
    assert list(passes) == ["gram", "states", "state_pass", "chunk_scan"]
    assert len(passes) == ssd.KERNELS_PER_CALL
    assert plan["scratch"] == {"G": (B, nc, Q, Q), "La": (B, nc, H, Q),
                               "states": (B, nc, H, P, N)}
    pt, nt = ssd.PT, ssd.NT
    # C B^T once per (batch, chunk), in strips of GS rows (no head axis),
    # beside blocks of one warp scan per head
    warps = ssd.THREADS // 32
    assert passes["gram"]["grid"] == (B * nc, -(-Q // ssd.GS)
                                      + -(-H // warps), 1)
    assert passes["states"]["grid"] == (B * nc * H, -(-P // pt), -(-N // nt))
    # the only sequential walk: one thread per (batch, head, state elem)
    assert passes["state_pass"]["grid"] == (-(-P * N // ssd.THREADS),
                                            B * H, 1)
    assert passes["chunk_scan"]["grid"] == (B * nc * H, -(-P // pt), 1)
    for name, p in passes.items():
        assert p["threads"] == ssd.THREADS
        assert p["smem"] <= SMEM_LIMIT
        # at least two blocks of each pass fit on an SM
        assert 2 * (p["smem"] + 1024) <= SM_SMEM, name


def test_ssd_plan_at_the_mamba2_shape():
    """The training shape's numbers, as the header note gives them."""
    plan = ssd.ssd_plan(1, 1024, 80, 64, 128, 128)["passes"]
    assert [p["grid"] for p in plan.values()] == [
        (8, 14, 1), (640, 1, 1), (32, 80, 1), (640, 1, 1)]
    assert [p["smem"] for p in plan.values()] == [83968, 98816, 0, 102912]


def test_ssd_wrapper_refuses_what_it_refused():
    """The kernel's refusals (metadata checks, so CPU tensors reach
    them): dtypes, contiguity, the largest chunk; shapes as before."""
    xh = torch.zeros((1, 512, 2, 16))
    a = torch.zeros((1, 512, 2))
    bc = torch.zeros((1, 512, 8))
    Q, plan = ssd.check_kernel_inputs(xh, a, bc, bc, 128)
    assert Q == 128 and plan["scratch"]["G"] == (1, 4, 128, 128)
    wide = torch.zeros((1, 512, 24)).bfloat16()
    ssd.check_kernel_inputs(xh, a, wide[..., 8:16], wide[..., 16:], 64)
    with pytest.raises(ValueError, match="does not fit"):
        ssd.check_kernel_inputs(xh, a, bc, bc, 256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd.check_kernel_inputs(xh, a, bc.half(), bc.half(), 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd.check_kernel_inputs(xh, a, bc, bc.bfloat16(), 64)
    with pytest.raises(ValueError, match="float32"):
        ssd.check_kernel_inputs(xh.bfloat16(), a, bc, bc, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.check_kernel_inputs(xh.transpose(2, 3).contiguous()
                                .transpose(2, 3), a, bc, bc, 64)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 512)).transpose(1, 2)
        ssd.check_kernel_inputs(xh, a, t, t, 64)
    with pytest.raises(ValueError, match="shape mismatch"):
        ssd.check_kernel_inputs(xh, a[:, :16], bc, bc, 64)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_plan_grids_and_scratch(case):
    """Three passes; the summary and rescan give every (b, chunk of 64
    steps, w) a thread, the carry pass every (b, w), in blocks of 128
    columns; one f32 scratch of (B, chunks, W) each for e, A and c."""
    B, S, W = case
    plan = rg.rglru_plan(B, S, W)
    nc = -(-S // rg.CHUNK)
    assert rg.CHUNK == 64 and plan["chunk"] == 64 and plan["chunks"] == nc
    assert (nc - 1) * 64 < S <= nc * 64
    passes = plan["passes"]
    assert list(passes) == list(rg.PASSES) == ["summary", "carry", "rescan"]
    assert len(passes) == rg.KERNELS_PER_CALL
    gx = -(-W // rg.THREADS)
    assert (gx - 1) * rg.THREADS < W <= gx * rg.THREADS
    assert passes["summary"]["grid"] == passes["rescan"]["grid"] == (
        gx, nc, B)
    assert passes["carry"]["grid"] == (gx, B, 1)
    assert all(p["threads"] == rg.THREADS == 128 for p in passes.values())
    assert plan["scratch"] == (3, B, nc, W)       # e, A and c
    assert plan["scratch_bytes"] == 3 * 4 * B * nc * W
    rg.check_kernel_inputs(torch.zeros(case), torch.zeros(case))


def test_rglru_plan_fills_the_card_at_the_recurrentgemma_shape():
    """(1, 2048, 4096): 32 chunks, 131072 threads in 1024 blocks for the
    summary and the rescan (the parent kernel: 4096 threads in 64 blocks
    on 132 SMs), the carry pass 32 steps long, 1.5 MB of scratch."""
    plan = rg.rglru_plan(1, 2048, 4096)
    assert [p["grid"] for p in plan["passes"].values()] == [
        (32, 32, 1), (32, 1, 1), (32, 32, 1)]
    summary = plan["passes"]["summary"]
    assert math.prod(summary["grid"]) * summary["threads"] == 131072
    assert math.prod(summary["grid"]) >= 132
    assert plan["chunks"] == 32 and plan["scratch_bytes"] == 1572864


def test_rglru_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's refusals (metadata checks, so CPU tensors reach
    them): dtypes, a strided last dimension, shapes, batches or chunk
    counts past the grid's 65535; batch and time strides are taken, and
    the fused dlog_a is the reverse mode's."""
    big = torch.zeros((2, 64, 3, 40))
    la, x = big[:, :, 0], big[:, :, 1]
    assert not la.is_contiguous()
    assert rg.check_kernel_inputs(la, x, big[:, :, 2])["chunks"] == 1
    with pytest.raises(ValueError, match="float32"):
        rg.check_kernel_inputs(la.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        rg.check_kernel_inputs(la, x, big[:, :, 2].double())
    with pytest.raises(ValueError, match="contiguous"):
        t = big[..., 0].transpose(1, 2)
        rg.check_kernel_inputs(t, t)
    with pytest.raises(ValueError, match="one shape"):
        rg.check_kernel_inputs(la, x[:, :8])
    with pytest.raises(ValueError, match="one shape"):
        rg.check_kernel_inputs(la, x, big[:, :8, 2])
    with pytest.raises(ValueError, match="one shape"):
        rg.check_kernel_inputs(la[0], x[0])
    wide = torch.zeros((1, 1, 8))
    rg.check_kernel_inputs(*[wide.expand(65535, 1, 8)] * 2)
    with pytest.raises(ValueError, match="65535"):
        rg.check_kernel_inputs(*[wide.expand(65536, 1, 8)] * 2)
    rg.check_kernel_inputs(*[wide.expand(1, 65535 * 64, 8)] * 2)
    with pytest.raises(ValueError, match="65535"):
        rg.check_kernel_inputs(*[wide.expand(1, 65535 * 64 + 1, 8)] * 2)
    with pytest.raises(ValueError, match="reverse"):
        rg.rglru_chunked(la, x, h=x)


# bf16 attention bar of the card checks (chip_smoke.TOL_BF16_ROW): 2^-6 of
# each row's largest |output|
TOL_BF16_ROW = 2 ** -6


def _emulated_mma_kernel(q, k, v, causal, window, cap, p_bits=8, reach=0):
    """The tensor-core kernel's roundings in plain torch: f32 scores and
    softmax, each p rounded to `p_bits` significant bits (bf16: 8) for
    P V while l sums the unrounded p, the output rounded to bf16. `reach`
    > 0 lets the causal and window masks admit that many keys too many
    (a faulty kernel)."""
    from repro_torch.kernels.ref import NEG_INF
    B, Sq, Hq, D = q.shape
    G = Hq // k.shape[2]
    kx = k.repeat_interleave(G, dim=2).float()
    vx = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / D ** 0.5
    if cap:
        s = torch.tanh(s / cap) * cap
    iq = torch.arange(Sq)[:, None]
    jk = torch.arange(k.shape[1])[None, :]
    m = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        m &= jk <= iq + reach
    if window:
        m &= jk > iq - window - reach
    s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    mant, ex = torch.frexp(p)
    pr = torch.ldexp(torch.round(mant * 2 ** p_bits) / 2 ** p_bits, ex)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, vx) / p.sum(-1).transpose(
        1, 2)[..., None]
    return o.to(torch.bfloat16)


def _row_rel_err(out, want):
    d = (out.float() - want).abs()
    return (d / want.abs().amax(dim=-1, keepdim=True)).max().item()


def _bf16_inputs(case, seed):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    if Sq >= 1000:      # the path shapes with fewer heads (CPU memory)
        Hq, Hkv = min(Hq, 4), min(Hkv, 4)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .bfloat16() for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                  (B, Skv, Hkv, D))]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_bf16_row_bar_holds_the_kernel_roundings(case):
    """The tensor-core kernel's roundings (bf16 P, bf16 output) stay well
    inside the card checks' per-row bar at every case, against the f32
    reference; the plain bf16 path (output rounding only) within 2^-8."""
    from repro_torch.kernels.ref import attention_reference
    causal, window, cap = case[6:]
    q, k, v = _bf16_inputs(case, 21)
    want = attention_reference(q.float(), k.float(), v.float(),
                               causal=causal, window=window, logit_cap=cap)
    plain = attention_reference(q, k, v, causal=causal, window=window,
                                logit_cap=cap)
    assert _row_rel_err(plain, want) <= 2 ** -8
    got = _emulated_mma_kernel(q, k, v, causal, window, cap)
    assert _row_rel_err(got, want) <= TOL_BF16_ROW / 2


@pytest.mark.parametrize("fault", ["mask reaches 2 keys", "p of 4 bits"])
@pytest.mark.parametrize("case", [ATTN_CASES[8], ATTN_CASES[11],
                                  ATTN_CASES[3]])
def test_bf16_row_bar_catches_a_faulty_kernel(case, fault):
    """A mask two keys too wide, or P rounded to 4 bits (an fp8 P), fails
    the per-row bar at the serve and windowed shapes. The earlier bar
    (3e-2 abs + rel per element) let the 4-bit P through at S=1024 and
    S=128."""
    from repro_torch.kernels.ref import attention_reference
    causal, window, cap = case[6:]
    q, k, v = _bf16_inputs(case, 22)
    want = attention_reference(q.float(), k.float(), v.float(),
                               causal=causal, window=window, logit_cap=cap)
    kw = dict(reach=2) if fault.startswith("mask") else dict(p_bits=4)
    got = _emulated_mma_kernel(q, k, v, causal, window, cap, **kw)
    assert _row_rel_err(got, want) > TOL_BF16_ROW
    if fault == "p of 4 bits" and case[1] != 4096:
        d = (got.float() - want).abs()
        assert bool((d <= 3e-2 + 3e-2 * want.abs()).all())
