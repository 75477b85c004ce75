"""GQA attention of the port, mirroring the JAX package's
`repro/models/attention.py`: the chunked online-softmax path and its
blocked (static causal/window extents) form as plain PyTorch, decode
attention against full or ring caches, and the `attend` dispatcher.

`impl="torch"` runs the plain path; `impl="cuda"` runs the hand-written
flash-attention kernel (`repro_torch.kernels.flash_attention`), the
port's counterpart of the JAX package's `impl="pallas"`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import softcap

NEG_INF = -1.0e30
MAX_Q_BLOCKS = 8


def _pick_chunk(skv: int, requested: int) -> int:
    if skv <= requested:
        return skv
    c = requested
    while skv % c:
        c //= 2
    return max(c, 1)


def _expand_kv(blk, G: int):
    """(B, C, Hkv, D) -> (B, C, Hkv*G, D) by repeating each kv head G x."""
    if G == 1:
        return blk
    return blk.repeat_interleave(G, dim=2)


def attend_blocked(q, k, v, *, causal: bool, window: int = 0,
                   logit_cap: float = 0.0, chunk: int = 1024):
    """Causal/windowed attention with static triangular KV extents: the
    queries are split into blocks, each attending only to the KV range
    its rows can see (see the JAX docstring for the extents)."""
    Sq, Skv = q.shape[1], k.shape[1]
    n_blocks = min(MAX_Q_BLOCKS, Sq)
    while Sq % n_blocks:
        n_blocks -= 1
    qblk = Sq // n_blocks
    outs = []
    for i in range(n_blocks):
        lo_q = i * qblk
        hi_kv = min((i + 1) * qblk, Skv) if causal else Skv
        lo_kv = 0
        if window:
            lo_kv = max(0, lo_q - window + 1)
            lo_kv = (lo_kv // chunk) * chunk
        outs.append(attend_chunked(
            q[:, lo_q:lo_q + qblk], k[:, lo_kv:hi_kv], v[:, lo_kv:hi_kv],
            causal=causal, window=window, logit_cap=logit_cap,
            q_offset=lo_q - lo_kv, chunk=chunk))
    return torch.cat(outs, dim=1)


def attend_chunked(q, k, v, *, causal: bool, window: int = 0,
                   logit_cap: float = 0.0, q_offset=0, kv_len=None,
                   chunk: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.
    window: 0 = unbounded; >0 = keys within [i - window + 1, i].
    q_offset: absolute position of q[0]. kv_len: keys at index >= kv_len
    are invalid. Returns (B, Sq, Hq, D) in q.dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qf = q.float() * (D ** -0.5)
    C = _pick_chunk(Skv, chunk)
    iq = (torch.arange(Sq, device=dev) + q_offset)[:, None]
    m = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, C):
        k_blk = _expand_kv(k[:, c0:c0 + C].float(), G)
        v_blk = _expand_kv(v[:, c0:c0 + C].float(), G)
        s = torch.einsum("bqhd,bchd->bqhc", qf, k_blk)
        if logit_cap:
            s = softcap(s, logit_cap)
        jc = c0 + torch.arange(C, device=dev)[None, :]
        mask = torch.ones((Sq, C), dtype=torch.bool, device=dev)
        if causal:
            mask &= jc <= iq
        if window:
            mask &= jc > iq - window
        if kv_len is not None:
            mask &= jc < kv_len
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhc,bchd->bqhd", p,
                                                   v_blk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def attend_decode(q, cache_k, cache_v, pos, *, window: int = 0,
                  logit_cap: float = 0.0, ring: bool = False):
    """One-step decode attention. q: (B, 1, Hq, D); cache: (B, S, Hkv, D).

    pos: absolute position of the current token (already written into
    the cache) — an int / 0-d tensor, or a (B,) tensor of per-row
    positions (continuous batching). With ring=True the cache length S
    equals the window and slot s holds absolute position
    `s + S*floor((pos - s)/S)`."""
    B, _, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, Hkv, G, D).float() * (D ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qg, cache_k.float())
    if logit_cap:
        s = softcap(s, logit_cap)
    slots = torch.arange(S, device=dev)
    pos = torch.as_tensor(pos, device=dev)
    posk = pos[:, None] if pos.dim() == 1 else pos
    if ring:
        slot_pos = slots + S * torch.div(posk - slots, S,
                                         rounding_mode="floor")
        valid = (slot_pos >= 0) & (slot_pos <= posk)
        if window:
            valid &= slot_pos > posk - window
    else:
        valid = slots <= posk
        if window:
            valid &= slots > posk - window
    if valid.dim() == 1:
        valid = valid[None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def attend(q, k, v, *, causal: bool, window: int = 0,
           logit_cap: float = 0.0, q_offset=0, kv_len=None,
           chunk: int = 1024, impl: str = "torch"):
    """Dispatcher: "torch" (chunked scan, blocked for causal/window) |
    "cuda" (the flash-attention kernel; on CPU tensors its plain
    reference)."""
    if impl == "torch":
        Sq, Skv = q.shape[1], k.shape[1]
        if ((causal or window) and Sq == Skv and kv_len is None
                and isinstance(q_offset, int) and q_offset == 0
                and Sq > chunk):
            return attend_blocked(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, chunk=chunk)
        return attend_chunked(q, k, v, causal=causal, window=window,
                              logit_cap=logit_cap, q_offset=q_offset,
                              kv_len=kv_len, chunk=chunk)
    if impl == "cuda":
        if kv_len is not None or not (isinstance(q_offset, int)
                                      and q_offset == 0):
            raise ValueError("the flash-attention kernel takes no "
                             "q_offset or kv_len")
        return flash_attention(q, k, v, causal=causal, window=window,
                               logit_cap=logit_cap)
    raise ValueError(f"unknown attention impl {impl!r}")
