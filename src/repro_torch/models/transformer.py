"""Model assembly of the port, mirroring the JAX package's
`repro/models/transformer.py`: blocks -> segments (repeated super-layers
with stacked parameters) -> decode caches.

Where JAX scans a segment's stacked parameters, the port loops in Python
over the layer index (`layer(tree, i)` takes the i-th slice of every
leaf, as views). The port carries the attention block (full or sliding
window, local and global alternating in gemma2; causal, or
bidirectional for encoder-only models and T5's encoder; with qkv
biases for qwen2.5), T5's cross-attention (`cross`) block over the
encoder states, and the RG-LRU (`rglru`) block, each followed by the
dense MLP (classic or gated) or the MoE FFN (`models/moe.py`, with an
always-on shared expert; kimi's leading layers dense) where the block
has one, and the attention-free Mamba-2 (`ssm`) block with no MLP; the
hybrid pattern of recurrentgemma repeats (rglru, rglru, attn) and puts
the remainder in a second segment; llama-3.2-vision repeats
`cross_attn_period - 1` attention blocks and one cross block (with the
dense MLP) over the image patch embeddings. With `post_block_norm`
(gemma2) the mixer's and the MLP's outputs are normed before each
residual add. Every
block has a one-token decode step against its cache (attention K/V, a
ring for windowed layers; the encoder's K/V for cross; the conv window
and recurrent state for rglru and ssm).

A block's aux losses (MoE: `moe_lb`, `moe_z`) are added into the `aux`
dict a caller passes to `apply_block`; decode steps drop them, as JAX's
do. Self-attention's output ("attn_out"), the MLP's hidden ("mlp_hidden")
and the experts' hidden ("moe_hidden") carry the memory tiers' marks
(`models/marks.py`), where the JAX layers carry theirs.

Decode steps update their caches IN PLACE (`index_put_` and `copy_` on
views of the stacked cache tensors) where JAX returns new, donated
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as m2
from repro_torch.models import rglru as rg
from repro_torch.models.attention import (attend, attend_decode,
                                         attend_marked)
from repro_torch.models.layers import (apply_mlp, apply_rope, dense_init,
                                       init_mlp, init_norm, rms_norm)
from repro_torch.models.moe import MoESettings, apply_moe, init_moe
from repro_torch.parallel.comm import tp_group

Params = Dict[str, Any]


# ====================================================================
# Segment construction
# ====================================================================

@dataclass(frozen=True)
class BlockDef:
    mixer: str                    # "attn" | "cross" | "rglru" | "ssm"
    window: int = 0               # sliding window for attn (0 = full)
    mlp: Optional[str] = "dense"  # "dense" | "moe" | None
    dense_ff: int = 0             # override d_ff for this block's dense MLP


@dataclass(frozen=True)
class SegmentDef:
    blocks: Tuple[BlockDef, ...]
    n_repeat: int


def build_segments(cfg: ModelConfig) -> List[SegmentDef]:
    """The segments of a config's layer stack: the decoder-only or
    encoder-only stack, or for an encoder-decoder its encoder's layers
    (`models/api.py` builds the decoder's own segment)."""
    if cfg.family == "ssm":
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
    if cfg.cross_attn_period:
        k = cfg.cross_attn_period
        if cfg.num_layers % k:
            raise ValueError("num_layers must be a multiple of "
                             "cross_attn_period")
        blocks = (BlockDef("attn"),) * (k - 1) + (BlockDef("cross"),)
        return [SegmentDef(blocks, cfg.num_layers // k)]
    mlp_kind = "moe" if cfg.moe_num_experts else "dense"
    if cfg.local_global_period:
        p = cfg.local_global_period
        if cfg.num_layers % p:
            raise ValueError("num_layers must be a multiple of "
                             "local_global_period")
        blocks = tuple(
            BlockDef("attn", window=cfg.sliding_window if i < p - 1 else 0,
                     mlp=mlp_kind)
            for i in range(p))
        return [SegmentDef(blocks, cfg.num_layers // p)]
    segs = []
    # kimi-style leading dense layers before the MoE ones
    n_dense = cfg.moe_first_dense_layers if mlp_kind == "moe" else 0
    if n_dense:
        segs.append(SegmentDef(
            (BlockDef("attn", window=cfg.sliding_window, mlp="dense",
                      dense_ff=cfg.moe_dense_ff or cfg.d_ff),), n_dense))
    segs.append(SegmentDef(
        (BlockDef("attn", window=cfg.sliding_window, mlp=mlp_kind),),
        cfg.num_layers - n_dense))
    return segs


# ====================================================================
# Run-time settings
# ====================================================================

@dataclass(frozen=True)
class RunSettings:
    attn_impl: str = "torch"          # torch | cuda
    attn_chunk: int = 1024
    param_dtype: str = "bfloat16"
    device: str = "cuda"
    # the jit engine's activation placement (the staged engine takes an
    # OffloadPolicy instead): "keep" | "remat" (layers recomputed in
    # backward) | "offload" / "offload_ssd" (recomputed, the named
    # tensors in pinned host memory until the layer's backward) |
    # "save_names" (recomputed, the named tensors kept on the device) |
    # "spool" (layer residuals through the spool)
    activation_policy: str = "keep"
    # the tensors "offload" moves to the host and "save_names" keeps, of
    # the names the layers mark (`core/policies.py::OFFLOAD_NAMES`):
    # "blk_in", a layer stage's input; "attn_out", self-attention's
    # output (the recompute then runs no attention forward);
    # "mlp_hidden", "moe_hidden", the MLP's and the experts' hidden. No
    # name is remat; another name is refused
    offload_names: Tuple[str, ...] = ("blk_in",)
    # "spool" only: a per-decoder-layer mask (None: every layer spools;
    # False keeps that layer's residuals on the device), as
    # AdaptivePolicy.plan_for_jit() emits it
    spool_stages: Optional[Tuple[bool, ...]] = None
    # the optimizer overlap's sink: when set, backward hands each layer
    # stage's gradients to `opt_sink.on_grads(step, stage, leaves)` once
    # its last microbatch has added them (repro_torch.optim.overlap)
    opt_sink: Any = None
    # chunked cross-entropy: the head's vocab projection and CE run per
    # sequence chunk of this many tokens (when it divides S and S is
    # longer), so the (B, S, V) f32 logits never exist; backward
    # recomputes one chunk's logits at a time. 0 = off
    ce_chunk: int = 0
    # the expert-parallel capacity factor (`ep_axis` only: the local MoE
    # path and a mesh without `ep_axis` are dropless and do not read it,
    # as JAX's do not)
    moe_capacity_factor: float = 1.25
    # this rank's mesh (`parallel/mesh.py`, with its `comm`) and the
    # roles of its axes: blocks split heads and d_ff over `tp_axis`, the
    # engine splits the batch and gathers fsdp leaves over `dp_axes`
    mesh: Any = None
    tp_axis: Optional[str] = None
    dp_axes: Tuple[str, ...] = ()
    # the expert-parallel axis: the MoE FFN's GShard capacity path
    # (`models/moe.py`); it must be the axis that splits the experts,
    # `tp_axis` ("model")
    ep_axis: Optional[str] = None
    # serving weights laid out fsdp (`launch/steps.py::_serve_fsdp`): the
    # parameters' `LeafSpec` tree (`core/meshrun.py::wrap_specs`). Each
    # layer's leaves, the embedding's and the head's are gathered over
    # `dp_axes` just before their use and dropped after
    # (`core/meshrun.py::fsdp_gather`). None: every leaf is the rank's
    # whole share (one device, TP-only serving, the training engine)
    fsdp_specs: Any = None


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
    p = {
        "wq": dense_init(gen, lead + (D, Hq, hd), D, dtype),
        "wk": dense_init(gen, lead + (D, KV, hd), D, dtype),
        "wv": dense_init(gen, lead + (D, KV, hd), D, dtype),
        "wo": dense_init(gen, lead + (Hq, hd, D), Hq * hd, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", Hq), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=dtype,
                                  device=gen.device)
    return p


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
    if cfg.post_block_norm:
        p["post_norm"] = init_norm(cfg.d_model, dtype, dev, lead)
    if bdef.mlp == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, bdef.dense_ff or cfg.d_ff,
                            dtype, lead, glu=cfg.mlp_glu)
    elif bdef.mlp == "moe":
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe_num_experts,
                            dtype, lead)
        if cfg.moe_shared_experts:
            p["moe_shared"] = init_mlp(
                gen, cfg.d_model, cfg.d_ff * cfg.moe_shared_experts, dtype,
                lead, glu=True)
    if bdef.mlp is not None:
        p["mlp_norm"] = init_norm(cfg.d_model, dtype, dev, lead)
        if cfg.post_block_norm:
            p["mlp_post_norm"] = init_norm(cfg.d_model, dtype, dev, lead)
    return p


# ====================================================================
# Block apply — full sequence (prefill)
# ====================================================================

def _proj(x, w):
    """"bsd,dhk->bshk" as one matrix product."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).unflatten(-1, (H, K))


def _kv_weights(p, cfg: ModelConfig, tp=None):
    """(wk, wv, bk, bv, whole): the kv projections of an attention or
    cross block. Under a tensor axis `tp` those whose heads the axis does
    not divide are whole on every rank (the sharding rules replicate
    them), so their gradient is summed over the axis, and the caller
    keeps the kv heads this rank's query heads read (`_local_kv`)."""
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    whole = bool(tp is not None and wk.shape[1] == cfg.num_kv_heads
                 and cfg.num_kv_heads % tp.size)
    if whole:
        if bk is None:
            wk, wv = tp.grad_sum(wk, wv)
        else:
            wk, wv, bk, bv = tp.grad_sum(wk, wv, bk, bv)
    return wk, wv, bk, bv, whole


def _qkv(p, x, cfg: ModelConfig, positions, tp=None, *,
         whole_kv: bool = False):
    """q, k, v of x. Under a tensor axis `tp` the projections hold this
    rank's heads (`_kv_weights` for kv heads the axis does not divide:
    k and v keep only the heads this rank's queries read, or with
    `whole_kv` every kv head, for a cache that holds them whole;
    `_rank_kv` then picks the rank's)."""
    wk, wv, bk, bv, kv_whole = _kv_weights(p, cfg, tp)
    q, k, v = _proj(x, p["wq"]), _proj(x, wk), _proj(x, wv)
    if "bq" in p:
        q, k, v = q + p["bq"], k + bk, v + bv
    if kv_whole and not whole_kv:
        k, v = _local_kv(k, v, cfg, tp)
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _rank_kv(k, v, cfg: ModelConfig, tp):
    """The kv heads this rank's queries read of k, v (B, S, H, D) that
    hold every kv head (the axis does not divide them: a cache kept whole
    on every rank, `parallel/sharding.py::cache_layout_specs`); k, v
    themselves when they are already the rank's."""
    if tp is None or k.shape[2] != cfg.num_kv_heads \
            or cfg.num_kv_heads % tp.size == 0:
        return k, v
    return _local_kv(k, v, cfg, tp)


def _local_kv(k, v, cfg: ModelConfig, tp):
    """The kv heads this rank's query heads read, of all `num_kv_heads`
    (query head h reads kv head h // (H / KV))."""
    first, n = tp.local_heads(cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    if n % group and group % n:
        raise ValueError(f"{cfg.name}: {n} query heads per rank do not "
                         f"tile kv groups of {group}")
    lo, hi = first // group, (first + n - 1) // group + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _out_proj(o, wo):
    """"bshk,hkd->bsd" as one matrix product."""
    H, K, D = wo.shape
    return o.flatten(-2) @ wo.reshape(H * K, D)


def _parallel_mlp(p, h, act: str, glu: bool, tp=None):
    """A dense MLP, column- then row-parallel under a tensor axis `tp`
    (this rank's share of d_ff, the output summed over the axis)."""
    if tp is None:
        return apply_mlp(p, h, act, glu)
    return tp.reduce(apply_mlp(p, tp.enter(h), act, glu))


def _mlp_sublayer(bdef: BlockDef, p, x, cfg: ModelConfig,
                  aux: Optional[Dict] = None, tp=None,
                  settings: Optional[RunSettings] = None):
    """x + MLP(rms_norm(x)) after a mixer whose block has an MLP: dense,
    or MoE (plus the shared expert), whose aux losses add into `aux`
    when given; the MLP's output normed first with `post_block_norm`.
    Under a tensor axis `tp` the dense MLP and the shared expert are
    column- then row-parallel, and the MoE FFN runs this rank's experts
    (`models/moe.py`) on `settings`' mesh."""
    if bdef.mlp is None:
        return x
    h = rms_norm(x, p["mlp_norm"]["scale"], cfg.norm_eps)
    if bdef.mlp == "dense":
        m = _parallel_mlp(p["mlp"], h, cfg.act, cfg.mlp_glu, tp)
    else:
        s = settings or RunSettings()
        # the router's statistics are summed over the dp axes only for
        # aux losses someone reads (not at serving)
        m, moe_aux = apply_moe(
            p["moe"], h, MoESettings(cfg.moe_num_experts, cfg.moe_top_k,
                                     s.moe_capacity_factor, cfg.act),
            mesh=s.mesh, ep_axis=s.ep_axis,
            dp_axes=s.dp_axes if aux is not None else (),
            tp_axis=s.tp_axis)
        if aux is not None:
            for k, v in moe_aux.items():
                aux[k] = aux[k] + v if k in aux else v
        if "moe_shared" in p:
            m = m + _parallel_mlp(p["moe_shared"], h, cfg.act, True, tp)
    return x + _post_norm(m, p, "mlp_post_norm", cfg)


def _post_norm(mix, p, name: str, cfg: ModelConfig):
    """gemma2's norm of a sublayer's output before its residual add."""
    if not cfg.post_block_norm:
        return mix
    return rms_norm(mix, p[name]["scale"], cfg.norm_eps)


def apply_block(bdef: BlockDef, p, x, cfg: ModelConfig,
                settings: RunSettings, *, positions=None, enc_kv=None,
                aux: Optional[Dict] = None, emit_cache: bool = False):
    """Full-sequence block. Returns (x, cache entry): (k, v) for an
    attention block, the encoder's (k, v) for a cross block,
    {"conv", "state"} for an ssm block, {"conv", "h"} for an rglru block.
    enc_kv: the encoder states (B, Se, D) a cross block attends to. An
    MoE block adds its aux losses into `aux` when given.

    With a tensor axis in `settings` (`parallel/comm.py::tp_group`) the
    parameters are this rank's shards: the normed input enters the
    parallel region, the mixer runs this rank's share, and its output is
    summed over the axis (Megatron). An attention or cross block runs
    its query heads (column-parallel q/k/v, row-parallel wo; a cross
    block's K/V projected from the encoder states, which enter the
    region too), an ssm block its SSM heads (`models/mamba2.py`), an
    rglru block its share of the width (`models/rglru.py`); the dense
    MLP and shared expert are column- then row-parallel, and the MoE FFN
    runs this rank's experts. A block whose kv heads the axis does not
    divide attends with the rank's (`_rank_kv`); with `emit_cache`
    (serving) an attention block returns them all as its cache entry,
    which every rank holds whole, as a cross block always does."""
    tp = tp_group(settings)
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    if tp is not None:
        h = tp.enter(h)
    if bdef.mixer == "cross":
        # each cross block projects its own K/V from the encoder states;
        # no RoPE, no mask, no window, no softcap
        if tp is not None:
            enc_kv = tp.enter(enc_kv)
        wk, wv = _kv_weights(p["attn"], cfg, tp)[:2]
        q = _proj(h, p["attn"]["wq"])
        cache = ek, ev = _proj(enc_kv, wk), _proj(enc_kv, wv)
        o = attend(q, *_rank_kv(ek, ev, cfg, tp), causal=False,
                   chunk=settings.attn_chunk, impl=settings.attn_impl)
        mix = _out_proj(o, p["attn"]["wo"])
    elif bdef.mixer == "ssm":
        mix, cache = m2.apply_mamba2(p["ssm"], h, cfg,
                                     impl=settings.attn_impl, tp=tp)
    elif bdef.mixer == "rglru":
        mix, cache = rg.apply_rglru(p["rglru"], h, cfg,
                                    impl=settings.attn_impl, tp=tp)
    else:
        q, k, v = _qkv(p["attn"], h, cfg, positions, tp,
                       whole_kv=emit_cache)
        cache = (k, v)
        if emit_cache:
            k, v = _rank_kv(k, v, cfg, tp)
        # the memory tiers' "attn_out" (self-attention only, as in JAX)
        o = attend_marked("attn_out", q, k, v, causal=cfg.causal,
                          window=bdef.window,
                          logit_cap=cfg.attn_logit_softcap,
                          chunk=settings.attn_chunk,
                          impl=settings.attn_impl)
        mix = _out_proj(o, p["attn"]["wo"])
    if tp is not None:
        mix = tp.reduce(mix)
    x = x + _post_norm(mix, p, "post_norm", cfg)
    return _mlp_sublayer(bdef, p, x, cfg, aux, tp, settings), cache


def check_tensor_axis(cfg: ModelConfig, tp_size: int) -> None:
    """A ValueError naming the shapes when a tensor axis of `tp_size`
    ranks does not divide what a block of `cfg` splits over it: the
    query heads of attention, mamba2's SSM heads, the RG-LRU width (JAX's
    rules would replicate those leaves instead)."""
    mixers = {b.mixer for seg in build_segments(cfg) for b in seg.blocks}
    if mixers & {"attn", "cross"} and cfg.num_heads % tp_size:
        raise ValueError(f"{cfg.name}: a tensor axis of {tp_size} ranks "
                         f"does not divide its {cfg.num_heads} query heads")
    if "ssm" in mixers:
        m2.tp_heads(m2.ssm_dims(cfg), tp_size)
    if "rglru" in mixers:
        rg.tp_width(cfg.rglru_width or cfg.d_model, tp_size)


# ====================================================================
# Block apply — single-token decode against caches
# ====================================================================

def _decode_positions(pos):
    """RoPE positions for one decode token: (1, 1) for a shared scalar
    pos, (B, 1) for per-row positions."""
    return pos[:, None] if pos.dim() == 1 else pos.reshape(1, 1)


def apply_block_decode(bdef: BlockDef, p, x1, cache, pos,
                       cfg: ModelConfig, settings: RunSettings):
    """x1: (B, 1, D). cache: the block's entry, views written in place:
    {"k", "v"}: (B, S, Hkv, D) for attn, the encoder's (B, Se, Hkv, D)
    for cross (read only), {"conv", "h"} for rglru, {"conv", "state"}
    for ssm. pos: 0-d tensor, or (B,) tensor of per-row positions.
    Returns x1.

    With a tensor axis in `settings` the parameters and the cache are
    this rank's shares (`init_block_cache` with `tp_size`), as in
    `apply_block`: the normed input enters the parallel region, the
    mixer decodes this rank's heads (kv heads the axis does not divide
    are held whole and the rank's picked, `_rank_kv`), its share of the
    RG-LRU width or its SSM heads, and the output is summed over the
    axis; the MLP, the shared expert and the MoE FFN run as in
    `apply_block`."""
    tp = tp_group(settings)
    h = rms_norm(x1, p["norm"]["scale"], cfg.norm_eps)
    if tp is not None:
        h = tp.enter(h)
    if bdef.mixer == "cross":
        q = _proj(h, p["attn"]["wq"])
        ck = cache["k"]
        o = attend_decode(q, *_rank_kv(ck, cache["v"], cfg, tp),
                          torch.tensor(ck.shape[1] - 1, device=x1.device))
        mix = _out_proj(o, p["attn"]["wo"])
    elif bdef.mixer == "rglru":
        mix = rg.decode_rglru(p["rglru"], h, cache, cfg, tp=tp)
    elif bdef.mixer == "ssm":
        mix = m2.decode_mamba2(p["ssm"], h, cache, cfg, tp=tp)
    else:
        mix = _attn_decode(bdef, p["attn"], h, cache, pos, cfg, tp)
    if tp is not None:
        mix = tp.reduce(mix)
    return _mlp_sublayer(bdef, p, x1 + _post_norm(mix, p, "post_norm", cfg),
                         cfg, None, tp, settings)


def _attn_decode(bdef: BlockDef, p, h, cache, pos, cfg: ModelConfig,
                 tp=None):
    """Self-attention of one decode token: writes its K/V into the
    (B, S, Hkv, D) cache (a ring when S is the window) and attends.
    Under a tensor axis `tp` the cache holds this rank's kv heads, or
    all of them where the axis does not divide them (`_rank_kv`)."""
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    ring = bool(bdef.window) and S == bdef.window
    q, k, v = _qkv(p, h, cfg, _decode_positions(pos), tp, whole_kv=True)
    slot = torch.remainder(pos, S) if ring else pos
    if pos.dim() == 1:
        rows = torch.arange(h.shape[0], device=h.device)
        ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
    else:
        s = int(slot)
        ck[:, s:s + 1] = k.to(ck.dtype)
        cv[:, s:s + 1] = v.to(cv.dtype)
    o = attend_decode(q, *_rank_kv(ck, cv, cfg, tp), pos,
                      window=bdef.window, logit_cap=cfg.attn_logit_softcap,
                      ring=ring)
    return _out_proj(o, p["wo"])


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
    mix = _post_norm(_out_proj(o, p["attn"]["wo"]), p, "post_norm", cfg)
    return _mlp_sublayer(bdef, p, x1 + mix, cfg)


# ====================================================================
# Decode-cache construction
# ====================================================================

def init_block_cache(bdef: BlockDef, cfg: ModelConfig, batch: int,
                     seq_len: int, dtype, device, lead=(),
                     tp_size: int = 1) -> Any:
    """Zeroed cache entry for one block, with leading dims `lead`: K/V
    (a ring of `window` slots for a windowed layer; the encoder's length
    `cfg.encoder_seq_len` for cross), or the conv window in `dtype` and
    the recurrent state in float32 whatever `dtype` is (rglru, ssm).

    `tp_size`: a rank's entry on a tensor axis of that many ranks
    (`parallel/sharding.py::cache_layout_specs`): the kv heads it
    divides split (else whole), the rank's share of the RG-LRU width,
    and the rank's SSM heads, its conv window x of those heads beside
    the whole B | C channels (`models/mamba2.py`)."""
    lead = tuple(lead)

    def zeros(shape, dt=dtype):
        return torch.zeros(lead + tuple(shape), dtype=dt, device=device)

    if bdef.mixer in ("attn", "cross"):
        if bdef.mixer == "cross":
            S = cfg.encoder_seq_len
        else:
            S = min(bdef.window, seq_len) if bdef.window else seq_len
        kv = cfg.num_kv_heads
        if kv % tp_size == 0:
            kv //= tp_size
        shape = (batch, S, kv, cfg.resolved_head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}
    if bdef.mixer == "rglru":
        W = rg.tp_width(cfg.rglru_width or cfg.d_model, tp_size)
        return {"conv": zeros((batch, cfg.rglru_conv_width - 1, W)),
                "h": zeros((batch, W), torch.float32)}
    if bdef.mixer == "ssm":
        dims = m2.ssm_dims(cfg)
        heads = m2.tp_heads(dims, tp_size)
        channels = heads * dims.head_dim + 2 * dims.state
        return {"conv": zeros((batch, cfg.ssm_conv_width - 1, channels)),
                "state": zeros((batch, heads, dims.head_dim, dims.state),
                               torch.float32)}
    raise ValueError(bdef.mixer)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="meta",
               tp_size: int = 1) -> List[Dict[str, Any]]:
    """The decode cache of `cfg` (the JAX package's `init_cache`): per
    segment {f"b{i}": entry}, each leaf stacked over the segment's
    repeats (`init_block_cache` with lead (n_repeat,)). On the meta
    device by default: shapes and dtypes only, as the dry run needs.
    On a mesh `batch` is the rank's rows and `tp_size` its tensor axis:
    the rank's share (`init_block_cache`)."""
    return [{f"b{i}": init_block_cache(bdef, cfg, batch, seq_len, dtype,
                                       device, lead=(seg.n_repeat,),
                                       tp_size=tp_size)
             for i, bdef in enumerate(seg.blocks)}
            for seg in build_segments(cfg)]
