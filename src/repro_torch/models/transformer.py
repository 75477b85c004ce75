"""Model assembly of the port, mirroring the JAX package's
`repro/models/transformer.py`: blocks -> segments (repeated super-layers
with stacked parameters) -> decode caches.

Where JAX scans a segment's stacked parameters, the port loops in Python
over the layer index (`layer(tree, i)` takes the i-th slice of every
leaf, as views). The port carries the attention block (full or sliding
window; causal, or bidirectional for encoder-only BERT and T5's
encoder), T5's cross-attention (`cross`) block over the encoder states,
and the RG-LRU (`rglru`) block, each followed by the dense MLP (classic
or gated) where the block has one, and the attention-free Mamba-2
(`ssm`) block with no MLP; the hybrid pattern of recurrentgemma repeats
(rglru, rglru, attn) and puts the remainder in a second segment. The
cross, rglru and ssm blocks have no decode step yet (training and
full-sequence forward only); configurations needing anything else raise
`NotImplementedError`.

Decode steps update their caches IN PLACE (`index_put_` on views of the
stacked cache tensors) where JAX returns new, donated arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as m2
from repro_torch.models import rglru as rg
from repro_torch.models.attention import attend, attend_decode
from repro_torch.models.layers import (apply_mlp, apply_rope, dense_init,
                                       init_mlp, init_norm, rms_norm)

_NOT_PORTED = "not ported yet (ROADMAP §1, 'the other architectures')"

Params = Dict[str, Any]


# ====================================================================
# Segment construction
# ====================================================================

@dataclass(frozen=True)
class BlockDef:
    mixer: str                    # "attn" | "cross" | "rglru" | "ssm"
    window: int = 0               # sliding window for attn (0 = full)
    mlp: Optional[str] = "dense"  # "dense" | None


@dataclass(frozen=True)
class SegmentDef:
    blocks: Tuple[BlockDef, ...]
    n_repeat: int


def build_segments(cfg: ModelConfig) -> List[SegmentDef]:
    """The segments of a config's layer stack: the decoder-only or
    encoder-only stack, or for an encoder-decoder its encoder's layers
    (`models/api.py` builds the decoder's own segment)."""
    ssm = cfg.family == "ssm"
    missing = [what for what, needed in (
        ("cross-attention layers (cross_attn_period)",
         bool(cfg.cross_attn_period)),
        ("MoE", bool(cfg.moe_num_experts)),
        ("embedding inputs", cfg.input_kind != "tokens"),
        ("qkv bias", cfg.qkv_bias and not ssm),
        ("post-block norms", cfg.post_block_norm),
        # the ssm block has no MLP: its act field is unused
        (f"activation {cfg.act!r}", cfg.act != "gelu" and not ssm))
        if needed]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} "
                                  f"{_NOT_PORTED}")
    if ssm:
        return [SegmentDef((BlockDef("ssm", mlp=None),), cfg.num_layers)]
    if cfg.hybrid_pattern:
        pat = tuple(
            BlockDef("attn", window=cfg.sliding_window) if k == "attn"
            else BlockDef("rglru") for k in cfg.hybrid_pattern)
        full, rem = divmod(cfg.num_layers, len(pat))
        segs = [SegmentDef(pat, full)] if full else []
        if rem:
            segs.append(SegmentDef(pat[:rem], 1))
        return segs
    if cfg.local_global_period:
        p = cfg.local_global_period
        if cfg.num_layers % p:
            raise ValueError("num_layers must be a multiple of "
                             "local_global_period")
        blocks = tuple(
            BlockDef("attn", window=cfg.sliding_window if i < p - 1 else 0)
            for i in range(p))
        return [SegmentDef(blocks, cfg.num_layers // p)]
    return [SegmentDef((BlockDef("attn", window=cfg.sliding_window),),
                       cfg.num_layers)]


# ====================================================================
# Run-time settings
# ====================================================================

@dataclass(frozen=True)
class RunSettings:
    attn_impl: str = "torch"          # torch | cuda
    attn_chunk: int = 1024
    param_dtype: str = "bfloat16"
    device: str = "cuda"


# ====================================================================
# Stacked-parameter helpers
# ====================================================================

def layer(tree, i: int):
    """The i-th slice of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack(trees: List):
    """Stack a list of same-structure trees along a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ====================================================================
# Block init (all n_repeat layers of a segment at once)
# ====================================================================

def _init_attn(gen, cfg: ModelConfig, dtype, lead) -> Params:
    D, Hq, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": dense_init(gen, lead + (D, Hq, hd), D, dtype),
        "wk": dense_init(gen, lead + (D, KV, hd), D, dtype),
        "wv": dense_init(gen, lead + (D, KV, hd), D, dtype),
        "wo": dense_init(gen, lead + (Hq, hd, D), Hq * hd, dtype),
    }


def init_block(gen, bdef: BlockDef, cfg: ModelConfig, dtype,
               n_repeat: int) -> Params:
    lead = (n_repeat,)
    dev = gen.device
    p: Params = {"norm": init_norm(cfg.d_model, dtype, dev, lead)}
    if bdef.mixer in ("attn", "cross"):
        p["attn"] = _init_attn(gen, cfg, dtype, lead)
    elif bdef.mixer == "rglru":
        p["rglru"] = rg.init_rglru(gen, cfg, dtype, lead)
    elif bdef.mixer == "ssm":
        p["ssm"] = m2.init_mamba2(gen, cfg, dtype, lead)
    else:
        raise ValueError(bdef.mixer)
    if bdef.mlp == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead,
                            glu=cfg.mlp_glu)
        p["mlp_norm"] = init_norm(cfg.d_model, dtype, dev, lead)
    return p


# ====================================================================
# Block apply — full sequence (prefill)
# ====================================================================

def _proj(x, w):
    """"bsd,dhk->bshk" as one matrix product."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).unflatten(-1, (H, K))


def _qkv(p, x, cfg: ModelConfig, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, wo):
    """"bshk,hkd->bsd" as one matrix product."""
    H, K, D = wo.shape
    return o.flatten(-2) @ wo.reshape(H * K, D)


def _mlp_sublayer(bdef: BlockDef, p, x, cfg: ModelConfig):
    """x + MLP(rms_norm(x)) after a mixer whose block has a dense MLP."""
    if bdef.mlp is None:
        return x
    h = rms_norm(x, p["mlp_norm"]["scale"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act, cfg.mlp_glu)


def apply_block(bdef: BlockDef, p, x, cfg: ModelConfig,
                settings: RunSettings, *, positions=None, enc_kv=None):
    """Full-sequence block. Returns (x, cache entry): (k, v) for an
    attention block, the encoder's (k, v) for a cross block,
    {"conv", "state"} for an ssm block, {"conv", "h"} for an rglru block.
    enc_kv: the encoder states (B, Se, D) a cross block attends to."""
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    if bdef.mixer == "cross":
        # each cross block projects its own K/V from the encoder states;
        # no RoPE, no mask, no window, no softcap
        q = _proj(h, p["attn"]["wq"])
        ek, ev = _proj(enc_kv, p["attn"]["wk"]), _proj(enc_kv,
                                                       p["attn"]["wv"])
        o = attend(q, ek, ev, causal=False, chunk=settings.attn_chunk,
                   impl=settings.attn_impl)
        mix, cache = _out_proj(o, p["attn"]["wo"]), (ek, ev)
    elif bdef.mixer == "ssm":
        mix, cache = m2.apply_mamba2(p["ssm"], h, cfg,
                                     impl=settings.attn_impl)
    elif bdef.mixer == "rglru":
        mix, cache = rg.apply_rglru(p["rglru"], h, cfg,
                                    impl=settings.attn_impl)
    else:
        q, k, v = _qkv(p["attn"], h, cfg, positions)
        o = attend(q, k, v, causal=cfg.causal, window=bdef.window,
                   logit_cap=cfg.attn_logit_softcap,
                   chunk=settings.attn_chunk, impl=settings.attn_impl)
        mix, cache = _out_proj(o, p["attn"]["wo"]), (k, v)
    return _mlp_sublayer(bdef, p, x + mix, cfg), cache


# ====================================================================
# Block apply — single-token decode against caches
# ====================================================================

def _decode_positions(pos):
    """RoPE positions for one decode token: (1, 1) for a shared scalar
    pos, (B, 1) for per-row positions."""
    return pos[:, None] if pos.dim() == 1 else pos.reshape(1, 1)


def apply_block_decode(bdef: BlockDef, p, x1, cache, pos,
                       cfg: ModelConfig, settings: RunSettings):
    """x1: (B, 1, D). cache: {"k", "v"}: (B, S, Hkv, D) views, written
    in place. pos: 0-d tensor, or (B,) tensor of per-row positions.
    Returns x1."""
    h = rms_norm(x1, p["norm"]["scale"], cfg.norm_eps)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    ring = bool(bdef.window) and S == bdef.window
    q, k, v = _qkv(p["attn"], h, cfg, _decode_positions(pos))
    slot = torch.remainder(pos, S) if ring else pos
    if pos.dim() == 1:
        rows = torch.arange(x1.shape[0], device=x1.device)
        ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
    else:
        s = int(slot)
        ck[:, s:s + 1] = k.to(ck.dtype)
        cv[:, s:s + 1] = v.to(cv.dtype)
    o = attend_decode(q, ck, cv, pos, window=bdef.window,
                      logit_cap=cfg.attn_logit_softcap, ring=ring)
    return _mlp_sublayer(bdef, p, x1 + _out_proj(o, p["attn"]["wo"]), cfg)


def apply_block_decode_paged(bdef: BlockDef, p, x1, pool, tables, pos,
                             cfg: ModelConfig, settings: RunSettings):
    """Paged-KV decode for one full-attention block.

      pool:   {"k","v"}: (N, P, Hkv, D) — N physical pages of P tokens
              for THIS layer (page 0 is the null page idle slots write
              into); written in place.
      tables: (B, max_pages) int64 — physical page of each logical page.
      pos:    (B,) int64 — absolute position of the current token.

    Scatters the new K/V into page pos//P at offset pos%P, gathers each
    row's pages into a contiguous (B, max_pages*P, Hkv, D) view and runs
    the dense decode attention on it, so the logits are bitwise those of
    a dense cache of length max_pages*P holding the same sequence.
    Returns x1."""
    h = rms_norm(x1, p["norm"]["scale"], cfg.norm_eps)
    ck, cv = pool["k"], pool["v"]
    P = ck.shape[1]
    B = x1.shape[0]
    n_pages = tables.shape[1]
    q, k, v = _qkv(p["attn"], h, cfg, _decode_positions(pos))
    rows = torch.arange(B, device=x1.device)
    phys = tables[rows, torch.div(pos, P, rounding_mode="floor")]
    off = torch.remainder(pos, P)
    ck.index_put_((phys, off), k[:, 0].to(ck.dtype))
    cv.index_put_((phys, off), v[:, 0].to(cv.dtype))
    gk = ck[tables].reshape(B, n_pages * P, *ck.shape[2:])
    gv = cv[tables].reshape(B, n_pages * P, *cv.shape[2:])
    o = attend_decode(q, gk, gv, pos, window=bdef.window,
                      logit_cap=cfg.attn_logit_softcap)
    return _mlp_sublayer(bdef, p, x1 + _out_proj(o, p["attn"]["wo"]), cfg)


# ====================================================================
# Decode-cache construction
# ====================================================================

def init_block_cache(bdef: BlockDef, cfg: ModelConfig, batch: int,
                     seq_len: int, dtype, device, lead=()) -> Any:
    """Zeroed cache entry for one block (a ring of `window` slots for a
    windowed layer)."""
    hd = cfg.resolved_head_dim
    S = min(bdef.window, seq_len) if bdef.window else seq_len
    shape = tuple(lead) + (batch, S, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

