"""Public model API of the port: build_model(config) -> ModelApi,
mirroring the JAX package's `repro/models/api.py`.

  init(generator)                               -> params
  forward(params, batch, settings, emit_cache=False, cache_len=0)
      -> logits_f32                       (emit_cache=False)
      -> (logits_f32, caches)             (emit_cache=True)
  loss(params, batch, settings)                 -> (loss, metrics)
  prefill(params, batch, settings, cache_len=0) -> (last_logits, caches)
  decode_step(params, cache, batch, pos, settings)  -> logits
  decode_step_paged(params, pools, resident, tables, batch, pos, settings)
      -> logits

Parameters are a nested dict of tensors with the JAX pytree keys and
stacked layer dims (`segments[0]["b0"]["attn"]["wq"]` is (L, D, H, hd)),
so `models/convert.py` maps JAX weights over key for key. The decode
steps update caches, pools and resident entries IN PLACE. Inputs and
outputs are the JAX package's layouts; the embedding tables are untied
and the vocab padded to a multiple of 256 with padded logits at -1e30.
Models without RoPE add a learned `pos_embed` table (max_position x D).
`embed_in` and `head` are the first and last pieces of the forward, which
the staged training engine runs as stages of their own. Decode (and
emitted caches) exist for attention blocks only so far: cross, rglru and
ssm blocks train and run full sequences.

An encoder-decoder (T5, `family == "encdec"`) adds `enc_segments` (the
bidirectional encoder stack) and `enc_norm`; the encoder embeds
`batch["enc_tokens"]` through the shared `embed` / `pos_embed` tables,
and every decoder layer is (causal self-attention, cross-attention with
the dense MLP) over the normed encoder states.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dtype_of, embed_init, init_norm,
                                       rms_norm, softcap)
from repro_torch.models.transformer import (BlockDef, RunSettings,
                                            SegmentDef, apply_block,
                                            apply_block_decode,
                                            apply_block_decode_paged,
                                            build_segments, init_block,
                                            layer, stack)

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    segments: Tuple[SegmentDef, ...]
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    decode_step_paged: Callable
    # the encoder's segments (an encoder-decoder's only; else empty)
    enc_segments: Tuple[SegmentDef, ...] = ()


def _to_decode_cache(bdef: BlockDef, cache, cache_len: int):
    """A prefill (k, v) pair in the decode layout: sized
    min(window, cache_len) (a ring for windowed layers, where position
    p lives at slot p % W, so a prefill of S tokens contributes its
    last W via a roll of (S - W) % W), zero-padded when shorter."""
    k, v = cache
    S = k.shape[1]
    target = min(bdef.window, cache_len) if bdef.window else cache_len
    if S >= target:
        k, v = k[:, S - target:], v[:, S - target:]
        shift = (S - target) % target
        if shift:
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, target - S)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return {"k": k, "v": v}


def _token_embed(params, tokens, cfg: ModelConfig):
    """Token embeddings, scaled by sqrt(d_model) in the parameter dtype
    when `cfg.scale_embed` (gemma-style)."""
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_in(params, batch, cfg: ModelConfig):
    """Token embeddings (`_token_embed`) plus learned positions for
    non-RoPE models."""
    x = _token_embed(params, batch["tokens"], cfg)
    if not cfg.use_rope:
        S = x.shape[1]
        x = x + params["pos_embed"][:S][None].to(x.dtype)
    return x


def ce_loss(logits, labels):
    """Mean next-token cross-entropy over labels >= 0, with the JAX
    package's masked-reduction label pick (`api.py::_ce_terms`): no
    gather, so its backward has no scatter-add. Returns (loss, tokens)."""
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    vmask = vocab[None, None] == labels.clamp_min(0)[..., None]
    picked = torch.where(vmask, logits, 0.0).sum(dim=-1)
    tokens = mask.sum()
    return ((lse - picked) * mask).sum() / tokens.clamp_min(1.0), tokens


def head(params, x, cfg: ModelConfig):
    """Final norm, unembedding and the padded-vocab mask: f32 logits."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = (x @ params["unembed"]).float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        bias = torch.zeros(cfg.padded_vocab, dtype=torch.float32,
                           device=logits.device)
        bias[cfg.vocab_size:] = -1e30
        logits = logits + bias
    return logits


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder-decoder's encoder runs under: bidirectional."""
    return dataclasses.replace(cfg, causal=False)


def build_model(cfg: ModelConfig) -> ModelApi:
    cfg = cfg.validate()
    segs = tuple(build_segments(cfg))
    enc_segs: Tuple[SegmentDef, ...] = ()
    if cfg.family == "encdec":
        if cfg.num_decoder_layers < 1:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             f"num_decoder_layers >= 1")
        enc_cfg = encoder_config(cfg)
        enc_segs = tuple(build_segments(enc_cfg))
        segs = (SegmentDef((BlockDef("attn", mlp=None),
                            BlockDef("cross", mlp="dense")),
                           cfg.num_decoder_layers),)

    def init(gen: torch.Generator) -> Params:
        """Random weights on the generator's device, in cfg.dtype."""
        dtype = dtype_of(cfg.dtype)
        dev = gen.device
        params: Params = {
            "final_norm": init_norm(cfg.d_model, dtype, dev),
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
            "unembed": embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                  dtype),
        }
        if not cfg.use_rope:
            params["pos_embed"] = embed_init(
                gen, (cfg.max_position, cfg.d_model), dtype)
        params["segments"] = [
            {f"b{i}": init_block(gen, bdef, cfg, dtype, seg.n_repeat)
             for i, bdef in enumerate(seg.blocks)} for seg in segs]
        if enc_segs:
            params["enc_segments"] = [
                {f"b{i}": init_block(gen, bdef, enc_cfg, dtype,
                                     seg.n_repeat)
                 for i, bdef in enumerate(seg.blocks)} for seg in enc_segs]
            params["enc_norm"] = init_norm(cfg.d_model, dtype, dev)
        return params

    def encode(params, batch, settings: RunSettings):
        """The encoder states of `batch["enc_tokens"]`: the shared tables'
        embedding, the bidirectional encoder stack, then `enc_norm`."""
        x = embed_in(params, {"tokens": batch["enc_tokens"]}, enc_cfg)
        positions = (torch.arange(x.shape[1], device=x.device)
                     if cfg.use_rope else None)
        for seg, p_stack in zip(enc_segs, params["enc_segments"]):
            for rep in range(seg.n_repeat):
                p_layer = layer(p_stack, rep)
                for i, bdef in enumerate(seg.blocks):
                    x, _ = apply_block(bdef, p_layer[f"b{i}"], x, enc_cfg,
                                       settings, positions=positions)
        return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)

    unserved = sorted({b.mixer for seg in segs for b in seg.blocks} - {
        "attn"})

    def _decode_ported():
        if unserved:
            raise NotImplementedError(
                f"{cfg.name}: decode caches of {' and '.join(unserved)} "
                "blocks are not ported yet (serving mamba2, the hybrid and "
                "T5 wait for a later slice)")

    def forward(params, batch, settings: RunSettings, *, emit_cache=False,
                cache_len=0):
        if emit_cache:
            _decode_ported()
        enc = encode(params, batch, settings) if enc_segs else None
        x = embed_in(params, batch, cfg)
        S = x.shape[1]
        positions = (torch.arange(S, device=x.device) if cfg.use_rope
                     else None)
        cache_len = cache_len or S
        caches = []
        for seg, p_stack in zip(segs, params["segments"]):
            entries = {f"b{i}": [] for i in range(len(seg.blocks))}
            for rep in range(seg.n_repeat):
                p_layer = layer(p_stack, rep)
                for i, bdef in enumerate(seg.blocks):
                    x, kv = apply_block(bdef, p_layer[f"b{i}"], x, cfg,
                                        settings, positions=positions,
                                        enc_kv=enc)
                    if emit_cache:
                        entries[f"b{i}"].append(
                            _to_decode_cache(bdef, kv, cache_len))
            if emit_cache:
                caches.append({bid: stack(e) for bid, e in entries.items()})
        logits = head(params, x, cfg)
        return (logits, caches) if emit_cache else logits

    def loss(params, batch, settings: RunSettings):
        """Mean CE over labels >= 0 -> (loss, {"ce", "tokens", "loss"})."""
        ce, tokens = ce_loss(forward(params, batch, settings),
                             batch["labels"])
        return ce, {"ce": ce, "tokens": tokens, "loss": ce}

    def prefill(params, batch, settings: RunSettings, *, cache_len=0):
        logits, caches = forward(params, batch, settings, emit_cache=True,
                                 cache_len=cache_len)
        return logits[:, -1:], caches

    def _decode_embed(params, batch, pos):
        """One decode token per row, embedded as `embed_in` embeds a
        prefill token (the JAX package's `api.py::_decode_embed`): scaled
        by sqrt(d_model) in the parameter dtype when `cfg.scale_embed`,
        plus the learned position `pos_embed[pos]` for non-RoPE models,
        per row for a (B,) `pos` and shared for a scalar one."""
        x = _token_embed(params, batch["tokens"], cfg)
        if not cfg.use_rope:
            pe = params["pos_embed"][pos].to(x.dtype)
            x = x + (pe[:, None] if pos.dim() == 1 else pe)
        return x

    def decode_step(params, cache, batch, pos, settings: RunSettings):
        """One token for the whole batch against dense caches (updated in
        place). batch: {"tokens": (B, 1)}. pos: int / 0-d tensor, or a
        (B,) tensor of per-row positions. Returns (B, 1, V) f32 logits."""
        _decode_ported()
        pos = torch.as_tensor(pos, device=params["embed"].device)
        x = _decode_embed(params, batch, pos)
        for seg, p_stack, c_stack in zip(segs, params["segments"], cache):
            for rep in range(seg.n_repeat):
                p_layer, c_layer = layer(p_stack, rep), layer(c_stack, rep)
                for i, bdef in enumerate(seg.blocks):
                    x = apply_block_decode(bdef, p_layer[f"b{i}"], x,
                                           c_layer[f"b{i}"], pos, cfg,
                                           settings)
        return head(params, x, cfg)

    def decode_step_paged(params, pools, resident, tables, batch, pos,
                          settings: RunSettings):
        """One token per serving slot against a paged KV cache. Blocks
        whose cache is pageable read/write the shared page pools through
        each row's page table; the rest keep per-slot dense entries in
        `resident`. All are updated in place.

          pools:    per segment {f"b{i}": {"k","v"}} page-pool stacks,
                    leading dim n_repeat, only for paged blocks.
          resident: per segment {f"b{i}": cache} stacks for the rest.
          tables:   (B, max_pages) physical page table per row.
          pos:      (B,) per-row absolute positions.

        Returns (B, 1, V) f32 logits."""
        _decode_ported()
        pos = torch.as_tensor(pos, device=params["embed"].device)
        x = _decode_embed(params, batch, pos)
        for seg, p_stack, pool_stack, res_stack in zip(
                segs, params["segments"], pools, resident):
            for rep in range(seg.n_repeat):
                p_layer = layer(p_stack, rep)
                for i, bdef in enumerate(seg.blocks):
                    bid = f"b{i}"
                    if bid in pool_stack:
                        x = apply_block_decode_paged(
                            bdef, p_layer[bid], x,
                            layer(pool_stack[bid], rep), tables, pos, cfg,
                            settings)
                    else:
                        x = apply_block_decode(
                            bdef, p_layer[bid], x,
                            layer(res_stack[bid], rep), pos, cfg, settings)
        return head(params, x, cfg)

    return ModelApi(
        cfg=cfg, segments=segs, init=init, forward=forward, loss=loss,
        prefill=prefill, decode_step=decode_step,
        decode_step_paged=decode_step_paged, enc_segments=enc_segs,
    )
