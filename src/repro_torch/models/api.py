"""Public model API of the port: build_model(config) -> ModelApi,
mirroring the JAX package's `repro/models/api.py`.

  init(generator)                               -> params
  forward(params, batch, settings, emit_cache=False, cache_len=0,
          with_aux=False)
      -> logits_f32                       (emit_cache=False)
      -> (logits_f32, caches)             (emit_cache=True)
      and the aux losses summed over layers last when with_aux
  loss(params, batch, settings)                 -> (loss, metrics)
  prefill(params, batch, settings, cache_len=0) -> (last_logits, caches)
  decode_step(params, cache, batch, pos, settings)  -> logits
  decode_step_paged(params, pools, resident, tables, batch, pos, settings)
      -> logits
  input_specs(shape, for_loss=True, device="meta")
      -> {"batch": ...} (decode: also "cache" and "pos")
  init_cache(batch, seq_len, dtype=bfloat16, device="meta", tp_size=1)
      -> caches (a tensor axis of `tp_size` ranks: one rank's share)

Parameters are a nested dict of tensors with the JAX pytree keys and
stacked layer dims (`segments[0]["b0"]["attn"]["wq"]` is (L, D, H, hd)),
so `models/convert.py` maps JAX weights over key for key. The decode
steps update caches, pools and resident entries IN PLACE. Inputs and
outputs are the JAX package's layouts; the embedding tables are untied
and the vocab padded to a multiple of 256 with padded logits at -1e30.
Models without RoPE add a learned `pos_embed` table (max_position x D).
A model of `input_kind == "embeddings"` (hubert) has no `embed` table:
its batches carry `embeddings` (B, S, D), which `frontend_proj` (D x D,
identity plus noise at init, as in JAX) projects. An MoE model's loss
adds `MOE_LB_COEF * moe_lb + MOE_Z_COEF * moe_z`, each summed over its
MoE layers, and reports both in its metrics.
`embed_in` and `head` are the first and last pieces of the forward, which
the staged training engine runs as stages of their own; `chunked_ce` is
the head and CE of `RunSettings.ce_chunk`, one sequence chunk at a time.
Every mixer emits a decode cache and decodes: attention K/V, the
encoder's K/V for cross blocks, the conv window and recurrent state of
rglru and ssm blocks. `input_specs` and `init_cache` give a cell's
inputs and decode cache as tensors of the JAX package's shapes and
dtypes, on the meta device unless the caller names another (the dry
run's step builders, `launch/steps.py`).

An encoder-decoder (T5, `family == "encdec"`) adds `enc_segments` (the
bidirectional encoder stack) and `enc_norm`; the encoder embeds
`batch["enc_tokens"]` through the shared `embed` / `pos_embed` tables,
and every decoder layer is (causal self-attention, cross-attention with
the dense MLP) over the normed encoder states. A vision model
(llama-3.2-vision, `family == "vlm"`) reads precomputed patch
embeddings, `batch["enc_embeddings"]` (B, encoder_seq_len, D), in
`forward`, `loss` and `prefill`; its cross blocks project their K/V
from them once at prefill, and the decode steps read those K/V from the
caches (`decode_step`) or from the resident entries
(`decode_step_paged`), never written.
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
from repro_torch.core.meshrun import fsdp_gather
from repro_torch.parallel.comm import (tp_group, vocab_parallel_dlogits,
                                       vocab_parallel_terms)
from repro_torch.models.transformer import (BlockDef, RunSettings,
                                            SegmentDef, apply_block,
                                            apply_block_decode,
                                            apply_block_decode_paged,
                                            build_segments, init_block,
                                            init_cache, layer, stack)

Params = Dict[str, Any]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 0.001


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
    input_specs: Callable = None
    init_cache: Callable = None


def _to_decode_cache(bdef: BlockDef, cache, cache_len: int):
    """A prefill cache entry in the decode layout. Attention (k, v):
    sized min(window, cache_len) (a ring for windowed layers, where
    position p lives at slot p % W, so a prefill of S tokens contributes
    its last W via a roll of (S - W) % W), zero-padded when shorter.
    Cross (k, v): the encoder's, at its length. rglru / ssm: already in
    the decode layout."""
    if bdef.mixer == "cross":
        k, v = cache
        return {"k": k, "v": v}
    if bdef.mixer != "attn":
        return cache
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


def _frontend_embed(params, embeddings, cfg: ModelConfig, tp=None):
    """Precomputed frame embeddings (B, S, D) through `frontend_proj`, in
    the parameter dtype (scaled as `_token_embed` scales). Under a tensor
    axis `tp` the projection holds this rank's columns of the width
    (column-parallel, the JAX spec (fsdp, tp)): each rank projects its
    columns and the width is gathered over the axis."""
    w = params["frontend_proj"]
    if tp is not None and w.shape[1] != cfg.d_model:
        with tp.region():
            x = embeddings.to(w.dtype) @ w
        x = tp.gather(x, x.dim() - 1)
    else:
        x = embeddings.to(w.dtype) @ w
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_in(params, batch, cfg: ModelConfig, tp=None):
    """Token embeddings (`_token_embed`), or for an embeddings-input model
    its frame embeddings through `frontend_proj`, plus learned positions
    for non-RoPE models. Under a tensor axis `tp`
    (`parallel/comm.py::TpGroup`) `embed` holds this rank's rows of the
    vocab (a token outside them looks up zeros; the ranks' lookups are
    all-reduced), `pos_embed` its columns of the width (the sequence's
    rows gathered), and `frontend_proj` its columns of the width too
    (`_frontend_embed`)."""
    if cfg.input_kind == "embeddings":
        x = _frontend_embed(params, batch["embeddings"], cfg, tp)
    elif tp is not None:
        x = _vocab_parallel_embed(params, batch["tokens"], cfg, tp)
    else:
        x = _token_embed(params, batch["tokens"], cfg)
    if not cfg.use_rope:
        pos = params["pos_embed"][:x.shape[1]]
        if tp is not None and pos.shape[1] != x.shape[-1]:
            pos = tp.gather(pos, 1)
        x = x + pos[None].to(x.dtype)
    return x


def _vocab_parallel_embed(params, tokens, cfg: ModelConfig, tp):
    """`_token_embed` over this rank's rows [rank*Vl, (rank+1)*Vl) of the
    vocab, all-reduced over the tensor axis."""
    table = params["embed"]
    vl = table.shape[0]
    with tp.region():
        local = tokens - tp.rank * vl
        inside = (local >= 0) & (local < vl)
        x = torch.where(inside[..., None], table[local.clamp(0, vl - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
    x = tp.reduce(x)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _label_mask(labels, vocab: int):
    """(B, S, V) bool: each row's label column (a label < 0 picks column
    0; its row is masked out of the sum)."""
    cols = torch.arange(vocab, device=labels.device)
    return cols[None, None] == labels.clamp_min(0)[..., None]


def _ce_terms(logits, labels):
    """(sum of the masked NLL, token count), with the JAX package's
    masked-reduction label pick (`api.py::_ce_terms`): no gather, so its
    backward has no scatter-add."""
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    vmask = _label_mask(labels, logits.shape[-1])
    picked = torch.where(vmask, logits, 0.0).sum(dim=-1)
    return ((lse - picked) * mask).sum(), mask.sum()


def ce_loss(logits, labels):
    """Mean next-token cross-entropy over labels >= 0. Returns (loss,
    tokens)."""
    nll, tokens = _ce_terms(logits, labels)
    return nll / tokens.clamp_min(1.0), tokens


def _vocab_bias(logits, cfg: ModelConfig, off: int = 0):
    """logits plus the padded-vocab mask (-1e30 past the vocab); `off`:
    the global column of the logits' first (a vocab-parallel slice)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    cols = off + torch.arange(logits.shape[-1], device=logits.device)
    bias = torch.where(cols >= cfg.vocab_size, -1e30, 0.0)
    return logits + bias


def head(params, x, cfg: ModelConfig, tp=None):
    """Final norm, unembedding and the padded-vocab mask: f32 logits.
    Under a tensor axis `tp` they are this rank's columns of the vocab
    (`unembed` holds them)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if tp is not None:
        x = tp.enter(x)
    logits = (x @ params["unembed"]).float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    off = tp.rank * logits.shape[-1] if tp is not None else 0
    return _vocab_bias(logits, cfg, off)


#: the leaves the embedding and the head read (serving gathers each set
#: just before its use when the weights are fsdp)
_EMBED_KEYS = ("embed", "pos_embed", "frontend_proj")
_HEAD_KEYS = ("final_norm", "unembed")


def _serve_part(params, settings: RunSettings, keys):
    """The leaves `keys` of `params` (those it has), their dp-sharded dims
    gathered when the serving weights are fsdp (`settings.fsdp_specs`)."""
    tree = {k: params[k] for k in keys if k in params}
    specs = settings.fsdp_specs
    return fsdp_gather(tree, None if specs is None else
                       {k: specs[k] for k in tree}, settings)


def _serve_layer(p_stack, spec_stack, rep: int, settings: RunSettings):
    """Layer `rep` of a segment's stacked parameters (views), gathered
    over the dp axes when the serving weights are fsdp."""
    p_layer = layer(p_stack, rep)
    if spec_stack is None:
        return p_layer
    return fsdp_gather(p_layer, layer(spec_stack, rep), settings)


def _seg_specs(settings: RunSettings, key: str, si: int):
    specs = settings.fsdp_specs
    return None if specs is None else specs[key][si]


def _serve_logits(params, x, cfg: ModelConfig, settings: RunSettings, *,
                 last: bool = False):
    """`head` of the final hidden state x, of its last position when
    `last`. Under a tensor axis each rank computes its vocab columns (the
    padded-vocab bias and the softcap per column slice) and the logits
    are gathered over the axis, so every rank returns the whole f32
    logits, as GSPMD's output is logically whole."""
    tp = tp_group(settings)
    z = head(_serve_part(params, settings, _HEAD_KEYS), x, cfg, tp)
    if last:
        z = z[:, -1:]
    return z if tp is None else tp.all_gather(z, z.dim() - 1)


def ce_chunk_applies(chunk: int, seq_len: int) -> bool:
    """The JAX package's rule for `RunSettings.ce_chunk`: chunk when it
    divides the sequence and the sequence is longer."""
    return bool(chunk) and seq_len % chunk == 0 and seq_len > chunk


class _ChunkedCE(torch.autograd.Function):
    """The head and the mean CE, `chunk` tokens of the sequence at a
    time (the JAX package's chunked `api.loss`, whose chunks run under
    remat). Forward drops each chunk's (B, chunk, V) f32 logits before
    the next and saves only its inputs, the final hidden state, the
    final norm's scale, the unembedding and the labels, through
    `save_for_backward`, where a saved-tensor hook sees them. Backward
    recomputes one chunk's logits at a time and accumulates the
    gradients of the hidden state, the scale and the unembedding (the
    last two in f32)."""

    @staticmethod
    def forward(ctx, x, scale, unembed, labels, chunk, cfg, tp):
        p = {"final_norm": {"scale": scale}, "unembed": unembed}
        nll, toks = [], []
        for c0 in range(0, x.shape[1], chunk):
            z = _head_plain(p, x[:, c0:c0 + chunk], cfg, tp)
            li = labels[:, c0:c0 + chunk]
            n, t = (_ce_terms(z, li) if tp is None
                    else vocab_parallel_terms(z, li, tp)[:2])
            nll.append(n)
            toks.append(t)
        tokens = torch.stack(toks).sum()
        ctx.save_for_backward(x, scale, unembed, labels)
        ctx.chunk, ctx.cfg, ctx.tp = chunk, cfg, tp
        ctx.mark_non_differentiable(tokens)
        return torch.stack(nll).sum() / tokens.clamp_min(1.0), tokens

    @staticmethod
    def backward(ctx, g, _):
        x, scale, unembed, labels = ctx.saved_tensors
        cfg, chunk, tp = ctx.cfg, ctx.chunk, ctx.tp
        need_x, need_scale, need_u = ctx.needs_input_grad[:3]
        coef = g.float() / (labels >= 0).sum().float().clamp_min(1.0)
        cap = cfg.final_logit_softcap
        dx = torch.empty_like(x) if need_x else None
        dscale = torch.zeros(scale.shape, dtype=torch.float32,
                             device=scale.device)
        du = torch.zeros(unembed.shape, dtype=torch.float32,
                         device=unembed.device)
        for c0 in range(0, x.shape[1], chunk):
            li = labels[:, c0:c0 + chunk]
            with torch.enable_grad():
                xi = x[:, c0:c0 + chunk].detach().requires_grad_(need_x)
                sc = scale.detach().requires_grad_(need_scale)
                h = rms_norm(xi, sc, cfg.norm_eps)
            hd = h.detach()
            z = (hd @ unembed).float()
            t = torch.tanh(z / cap) if cap else None
            off = tp.rank * z.shape[-1] if tp is not None else 0
            zb = _vocab_bias(t * cap if cap else z, cfg, off)
            del z
            # d(lse - picked)/d logits = softmax - onehot, on masked rows
            if tp is None:
                dl = torch.softmax(zb, dim=-1)
                dl.sub_(_label_mask(li, dl.shape[-1]).float())
                dl.mul_((coef * (li >= 0).float())[..., None])
            else:
                lse = vocab_parallel_terms(zb, li, tp)[2]
                dl = vocab_parallel_dlogits(zb, li, lse, coef, off)
            del zb
            if cap:
                dl.mul_(1.0 - t * t)
            del t
            dz = dl.to(hd.dtype)
            del dl
            if need_u:
                du += (hd.flatten(0, 1).t() @ dz.flatten(0, 1)).float()
            dh = dz @ unembed.t()
            del dz
            if tp is not None:
                # each rank's columns give a share of the hidden
                # state's gradient: their sum is the whole of it
                dh = tp.comm.all_reduce_sum(dh, tp.axes)
            wrt = [v for v, n in ((xi, need_x), (sc, need_scale)) if n]
            if wrt:
                got = torch.autograd.grad(h, wrt, dh)
                if need_x:
                    dx[:, c0:c0 + chunk] = got[0]
                if need_scale:
                    dscale += got[-1].float()
        return (dx, dscale.to(scale.dtype) if need_scale else None,
                du.to(unembed.dtype) if need_u else None, None, None, None,
                None)


def _head_plain(p, x, cfg: ModelConfig, tp):
    """`head` for the chunked CE's forward: no `enter` (the Function
    all-reduces the hidden state's gradient itself)."""
    x = rms_norm(x, p["final_norm"]["scale"], cfg.norm_eps)
    logits = (x @ p["unembed"]).float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return _vocab_bias(logits, cfg,
                       tp.rank * logits.shape[-1] if tp is not None else 0)


def chunked_ce(params, x, labels, cfg: ModelConfig, chunk: int, tp=None):
    """The mean CE of the head over the final hidden state x (B, S, D),
    `chunk` tokens at a time (`_ChunkedCE`). Returns (loss, tokens).
    Under a tensor axis `tp` `unembed` holds this rank's vocab columns
    (`parallel/comm.py::vocab_parallel_terms`)."""
    return _ChunkedCE.apply(x, params["final_norm"]["scale"],
                            params["unembed"], labels, chunk, cfg, tp)


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
        params: Params = {"final_norm": init_norm(cfg.d_model, dtype, dev)}
        if cfg.input_kind == "embeddings":
            noise = torch.randn((cfg.d_model, cfg.d_model), generator=gen,
                                device=dev)
            params["frontend_proj"] = (
                torch.eye(cfg.d_model, device=dev) + 0.02 * noise).to(dtype)
        else:
            params["embed"] = embed_init(
                gen, (cfg.padded_vocab, cfg.d_model), dtype)
        params["unembed"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       dtype)
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
        embedding, the bidirectional encoder stack, then `enc_norm`
        (tensor-parallel on `settings`' axis, fsdp weights gathered a
        layer at a time, as `hidden` runs the decoder)."""
        tp = tp_group(settings)
        x = embed_in(_serve_part(params, settings, _EMBED_KEYS),
                     {"tokens": batch["enc_tokens"]}, enc_cfg, tp)
        positions = (torch.arange(x.shape[1], device=x.device)
                     if cfg.use_rope else None)
        for si, (seg, p_stack) in enumerate(zip(enc_segs,
                                                params["enc_segments"])):
            s_stack = _seg_specs(settings, "enc_segments", si)
            for rep in range(seg.n_repeat):
                p_layer = _serve_layer(p_stack, s_stack, rep, settings)
                for i, bdef in enumerate(seg.blocks):
                    x, _ = apply_block(bdef, p_layer[f"b{i}"], x, enc_cfg,
                                       settings, positions=positions)
                del p_layer
        norm = _serve_part(params, settings, ("enc_norm",))["enc_norm"]
        return rms_norm(x, norm["scale"], cfg.norm_eps)

    def enc_states(params, batch, settings: RunSettings):
        """What the cross blocks attend to: an encoder-decoder's encoder
        states, a vision model's `batch["enc_embeddings"]` (B, Se, D)
        cast to `cfg.dtype` (its frontend is a stub in both packages),
        else None."""
        if enc_segs:
            return encode(params, batch, settings)
        if cfg.family == "vlm":
            return batch["enc_embeddings"].to(dtype_of(cfg.dtype))
        return None

    def hidden(params, batch, settings: RunSettings, *, emit_cache=False,
               cache_len=0, with_aux=True):
        """The final hidden state (before the head), the decode caches
        when `emit_cache` (else an empty list), and the blocks' aux
        losses summed over layers (none collected without `with_aux`).

        With a tensor axis in `settings` (`parallel/comm.py::tp_group`)
        the embedding is vocab-parallel (`embed_in`) and every block
        runs this rank's share (`apply_block`), so the caches are the
        rank's (`init_cache` with `tp_size`); with fsdp serving weights
        (`settings.fsdp_specs`) each layer's leaves are gathered over
        the dp axes just before its blocks run and dropped after, the
        embedding's around the lookup."""
        tp = tp_group(settings)
        enc = enc_states(params, batch, settings)
        x = embed_in(_serve_part(params, settings, _EMBED_KEYS), batch, cfg,
                     tp)
        S = x.shape[1]
        positions = (torch.arange(S, device=x.device) if cfg.use_rope
                     else None)
        cache_len = cache_len or S
        caches, aux = [], ({} if with_aux else None)
        for si, (seg, p_stack) in enumerate(zip(segs, params["segments"])):
            s_stack = _seg_specs(settings, "segments", si)
            entries = {f"b{i}": [] for i in range(len(seg.blocks))}
            for rep in range(seg.n_repeat):
                p_layer = _serve_layer(p_stack, s_stack, rep, settings)
                for i, bdef in enumerate(seg.blocks):
                    x, kv = apply_block(bdef, p_layer[f"b{i}"], x, cfg,
                                        settings, positions=positions,
                                        enc_kv=enc, aux=aux,
                                        emit_cache=emit_cache)
                    if emit_cache:
                        entries[f"b{i}"].append(
                            _to_decode_cache(bdef, kv, cache_len))
                del p_layer
            if emit_cache:
                caches.append({bid: stack(e) for bid, e in entries.items()})
        return x, caches, aux or {}

    def forward(params, batch, settings: RunSettings, *, emit_cache=False,
                cache_len=0, with_aux=False):
        x, caches, aux = hidden(params, batch, settings,
                                emit_cache=emit_cache, cache_len=cache_len,
                                with_aux=with_aux)
        out = (_serve_logits(params, x, cfg, settings),)
        out += (caches,) if emit_cache else ()
        out += (aux,) if with_aux else ()
        return out if len(out) > 1 else out[0]

    def loss(params, batch, settings: RunSettings):
        """Mean CE over labels >= 0, plus the MoE aux terms ->
        (loss, {"ce", "tokens", "loss"} and "moe_lb", "moe_z" for an MoE
        model), chunked (`chunked_ce`) when `settings.ce_chunk` applies."""
        labels = batch["labels"]
        x, _, aux = hidden(params, batch, settings)
        if ce_chunk_applies(settings.ce_chunk, labels.shape[1]):
            ce, tokens = chunked_ce(params, x, labels, cfg,
                                    settings.ce_chunk)
        else:
            ce, tokens = ce_loss(head(params, x, cfg), labels)
        total = ce
        metrics = {"ce": ce, "tokens": tokens}
        if "moe_lb" in aux:
            total = ce + MOE_LB_COEF * aux["moe_lb"] \
                + MOE_Z_COEF * aux["moe_z"]
            metrics.update(moe_lb=aux["moe_lb"], moe_z=aux["moe_z"])
        metrics["loss"] = total
        return total, metrics

    def prefill(params, batch, settings: RunSettings, *, cache_len=0):
        """(the last position's f32 logits (B, 1, V), the decode caches
        of `cache_len` positions); on a mesh this rank's rows, the whole
        logits on every rank of the tensor axis (`_serve_logits`) and the
        rank's share of the caches."""
        x, caches, _ = hidden(params, batch, settings, emit_cache=True,
                              cache_len=cache_len, with_aux=False)
        return _serve_logits(params, x, cfg, settings, last=True), caches

    def _decode_embed(params, batch, pos, settings: RunSettings):
        """One decode token per row, embedded as `embed_in` embeds a
        prefill token (the JAX package's `api.py::_decode_embed`): scaled
        by sqrt(d_model) in the parameter dtype when `cfg.scale_embed`,
        plus the learned position `pos_embed[pos]` for non-RoPE models,
        per row for a (B,) `pos` and shared for a scalar one; an
        embeddings-input model's `batch["embeddings"]` (B, 1, D) through
        `frontend_proj`. Under a tensor axis the lookup is
        vocab-parallel and the position's row of `pos_embed` is gathered
        over the axis, added once."""
        tp = tp_group(settings)
        emb = _serve_part(params, settings, _EMBED_KEYS)
        if cfg.input_kind == "embeddings":
            x = _frontend_embed(emb, batch["embeddings"], cfg, tp)
        elif tp is not None:
            x = _vocab_parallel_embed(emb, batch["tokens"], cfg, tp)
        else:
            x = _token_embed(emb, batch["tokens"], cfg)
        if not cfg.use_rope:
            pe = emb["pos_embed"][pos]
            if tp is not None and pe.shape[-1] != cfg.d_model:
                pe = tp.all_gather(pe, pe.dim() - 1)
            pe = pe.to(x.dtype)
            x = x + (pe[:, None] if pos.dim() == 1 else pe)
        return x

    def decode_step(params, cache, batch, pos, settings: RunSettings):
        """One token for the whole batch against dense caches (updated in
        place). batch: {"tokens": (B, 1)}. pos: int / 0-d tensor, or a
        (B,) tensor of per-row positions. Returns (B, 1, V) f32 logits.
        On a mesh: this rank's rows and its share of the caches
        (`apply_block_decode`), fsdp weights gathered a layer at a time,
        and the whole logits on every rank (`_serve_logits`)."""
        pos = torch.as_tensor(pos, device=params["unembed"].device)
        x = _decode_embed(params, batch, pos, settings)
        for si, (seg, p_stack, c_stack) in enumerate(
                zip(segs, params["segments"], cache)):
            s_stack = _seg_specs(settings, "segments", si)
            for rep in range(seg.n_repeat):
                p_layer = _serve_layer(p_stack, s_stack, rep, settings)
                c_layer = layer(c_stack, rep)
                for i, bdef in enumerate(seg.blocks):
                    x = apply_block_decode(bdef, p_layer[f"b{i}"], x,
                                           c_layer[f"b{i}"], pos, cfg,
                                           settings)
                del p_layer
        return _serve_logits(params, x, cfg, settings)

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
        pos = torch.as_tensor(pos, device=params["unembed"].device)
        x = _decode_embed(params, batch, pos, settings)
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

    def input_specs(shape, *, for_loss: bool = True, device="meta"):
        """Every model input of a cell (`configs.ShapeConfig`) as an
        empty tensor of the JAX package's shape and dtype (int32 ids,
        bf16 embeddings) on `device`; a decode cell adds its cache
        (`init_cache`) and the position."""
        B, S = shape.global_batch, shape.seq_len

        def empty(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=device)

        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind == "decode":
            batch = ({"embeddings": empty((B, 1, cfg.d_model), bf16)}
                     if cfg.input_kind == "embeddings"
                     else {"tokens": empty((B, 1), i32)})
            return {"batch": batch,
                    "cache": init_cache(cfg, B, S, device=device),
                    "pos": empty((), i32)}
        batch: Dict[str, Any] = {}
        if cfg.input_kind == "embeddings":
            batch["embeddings"] = empty((B, S, cfg.d_model), bf16)
        else:
            batch["tokens"] = empty((B, S), i32)
        if cfg.family == "vlm":
            batch["enc_embeddings"] = empty(
                (B, cfg.encoder_seq_len, cfg.d_model), bf16)
        if cfg.family == "encdec":
            batch["enc_tokens"] = empty((B, S), i32)
        if for_loss and shape.kind == "train":
            batch["labels"] = empty((B, S), i32)
        return {"batch": batch}

    return ModelApi(
        cfg=cfg, segments=segs, init=init, forward=forward, loss=loss,
        prefill=prefill, decode_step=decode_step,
        decode_step_paged=decode_step_paged, enc_segments=enc_segs,
        input_specs=input_specs,
        init_cache=lambda B, S, dtype=torch.bfloat16, device="meta",
        tp_size=1: init_cache(cfg, B, S, dtype, device, tp_size),
    )
