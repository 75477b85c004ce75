"""Plain PyTorch reference of the attention kernel: the simplest correct
formulation (full score matrix), a copy of the JAX package's
`repro/kernels/ref.py::attention_reference`. The CPU path of
`flash_attention` and the comparisons on the card use it."""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0):
    """Direct softmax attention in f32. q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D).
    Returns (B,Sq,Hq,D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kx = k.repeat_interleave(G, dim=2).float()
    vx = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(D)
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    iq = torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= jk <= iq
    if window:
        mask &= jk > iq - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    return o.to(q.dtype)
