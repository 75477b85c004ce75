"""Card-only tests of the port: the hand-written CUDA flash-attention
kernel against its plain PyTorch version, and the serve path through the
kernel. A CUDA kernel has no CPU mode, so without a card these skip;
on the card run `PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py`. This file imports no jax (the card's machine
has none)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_reference
from repro_torch.launch import serve

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case,dtype,tol",
                         [(c, torch.float32, 2e-5) for c in ATTN_CASES]
                         + [(c, torch.bfloat16, 3e-2) for c in SERVE_CASES])
def test_kernel_matches_plain(card, case, dtype, tol):
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
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)


def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 48), device=card)           # D=48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q)


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
