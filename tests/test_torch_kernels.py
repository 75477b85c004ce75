"""The port's attention kernel module and attention paths against the JAX
package: the plain reference and the `flash_attention` wrapper (which
takes its plain path on CPU tensors) against JAX's oracle and its Pallas
kernel in interpret mode, the chunked/blocked online-softmax paths and
decode attention. Inputs come from numpy with a seed and reach both
frameworks as the same bits. The CUDA kernel itself runs only on the
card: its tests are in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import attention_reference  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# (B, Sq, Skv, Hq, Hkv, D, causal, window, cap): tests/test_kernels.py
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),      # MHA causal
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),        # GQA
    (2, 64, 64, 4, 1, 32, True, 0, 0.0),        # MQA
    (1, 128, 128, 2, 2, 64, True, 32, 0.0),     # sliding window
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),       # logit softcap
    (2, 64, 64, 4, 4, 32, False, 0, 0.0),       # bidirectional
    (1, 96, 96, 2, 2, 32, True, 0, 0.0),        # non-multiple of block
    (1, 16, 16, 2, 2, 128, True, 0, 0.0),       # short seq, wide head
]
TOL = 2e-5          # f32: both sides sum in f32, in different orders
TOL_BF16 = 3e-2     # one bf16 rounding of the output


def _qkv(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap", ATTN_CASES)
def test_flash_attention_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal, window,
                                     cap):
    q, k, v = _qkv(0, B, Sq, Skv, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    want = np.asarray(jref.attention_reference(*_j(q, k, v), **kw))
    pallas = np.asarray(ops.flash_attention(*_j(q, k, v), interpret=True,
                                            **kw))
    launches = flash_attention.launches
    for got in (attention_reference(*_t(q, k, v), **kw),
                flash_attention(*_t(q, k, v), **kw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    assert flash_attention.launches == launches   # CPU: no kernel launch


def test_flash_attention_bf16_matches_jax():
    q, k, v = _qkv(1, 2, 64, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (t.bfloat16() for t in _t(q, k, v))
    want = ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL_BF16, atol=TOL_BF16)


CHUNKED_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, cap, q_offset, kv_len, chunk)
    (2, 32, 32, 4, 2, 16, True, 0, 0.0, 0, None, 8),
    (2, 8, 32, 4, 2, 16, True, 0, 0.0, 24, None, 8),     # continuation
    (1, 8, 32, 2, 1, 16, True, 0, 0.0, 20, 28, 8),       # + invalid tail
    (1, 24, 24, 2, 2, 16, True, 6, 0.0, 0, None, 8),     # window
    (2, 16, 16, 4, 4, 16, False, 0, 20.0, 0, 12, 4),     # bidir + cap
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap,q_offset,"
                         "kv_len,chunk", CHUNKED_CASES)
def test_attend_chunked_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal, window,
                                    cap, q_offset, kv_len, chunk):
    q, k, v = _qkv(2, B, Sq, Skv, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len, chunk=chunk)
    want = jattn.attend_chunked(*_j(q, k, v), **kw)
    got = tattn.attend_chunked(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20),
                                           (False, 12)])
def test_attend_blocked_and_dispatch_match_jax(causal, window):
    q, k, v = _qkv(3, 2, 64, 64, 4, 2, 16)
    kw = dict(causal=causal, window=window, chunk=16)
    want = np.asarray(jattn.attend_blocked(*_j(q, k, v), **kw))
    got = tattn.attend_blocked(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the dispatcher picks the blocked path for Sq == Skv > chunk and
    # the kernel path (its plain reference on CPU) for impl="cuda"
    for impl in ("torch", "cuda"):
        out = tattn.attend(*_t(q, k, v), impl=impl, **kw)
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def test_attend_dispatch_rejects():
    q, k, v = _t(*_qkv(4, 1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="q_offset or kv_len"):
        tattn.attend(q, k, v, causal=True, kv_len=4, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attend(q, k, v, causal=True, impl="pallas")
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, k[:, :, :, :16], v)


@pytest.mark.parametrize("pos,window,ring", [
    (9, 0, False),                     # shared scalar position
    ([3, 15, 7], 0, False),            # per-row positions
    ([3, 15, 7], 5, False),            # window over a full cache
    ([3, 21, 40], 16, True),           # ring cache of the window length
])
def test_attend_decode_matches_jax(pos, window, ring):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    ck = rng.normal(size=(3, 16, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(3, 16, 2, 16)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = jattn.attend_decode(*_j(q, ck, cv), jnp.asarray(p),
                               window=window, ring=ring)
    got = tattn.attend_decode(*_t(q, ck, cv), torch.from_numpy(p).long(),
                              window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_build_names_one_library_per_source():
    assert build.sources() == ["flash_attention_fwd", "rglru_scan_fwd",
                               "ssd_scan_fwd"]
    for name in build.sources():
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
