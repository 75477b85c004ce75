"""Plain PyTorch references, the simplest correct formulations, copied
from the JAX package's `repro/kernels/ref.py`: `attention_reference`
(full score matrix; the CPU path of `flash_attention`, its backward, and
the comparisons on the card use it), `ssd_reference` (the exact
sequential SSD recurrence) and `rglru_reference` (the exact sequential
RG-LRU recurrence), the last two for the tests."""
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


def ssd_reference(xh, dA_log, B_s, C_s):
    """Exact sequential SSD recurrence (no chunking).

    xh: (B,S,H,P); dA_log: (B,S,H); B_s, C_s: (B,S,N).
    state_t = exp(dA_log_t) * state_{t-1} + B_t (x) xh_t
    y_t     = C_t . state_t
    Returns (y (B,S,H,P) f32, final state (B,H,P,N) f32)."""
    B, S, H, P = xh.shape
    N = B_s.shape[-1]
    xh, dA_log = xh.float(), dA_log.float()
    B_s, C_s = B_s.float(), C_s.float()
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        state = (state * torch.exp(dA_log[:, t])[:, :, None, None]
                 + torch.einsum("bn,bhp->bhpn", B_s[:, t], xh[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", C_s[:, t], state))
    return torch.stack(ys, dim=1), state


def rglru_reference(log_a, x):
    """Exact sequential h_t = exp(log_a_t) h_{t-1} + x_t over axis 1, in
    f32. log_a, x: (B, S, W). Returns h: (B, S, W) f32."""
    log_a, x = log_a.float(), x.float()
    h = torch.zeros((x.shape[0],) + x.shape[2:], dtype=torch.float32,
                    device=x.device)
    hs = []
    for t in range(x.shape[1]):
        h = torch.exp(log_a[:, t]) * h + x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
