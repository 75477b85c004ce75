"""SSD write amount, bandwidth and lifespan (paper §3.4, Fig. 9, Table
4), ported from the JAX package's `repro/core/endurance.py`.

1. `residual_bytes_per_layer(cfg, batch, seq)`: the exact bytes one
   layer's stage hands the spool, counted as the staged engine's pack
   hook counts them (parameters excluded by storage, the stage input
   excluded, duplicates removed by storage, offset, shape and stride,
   tensors under `MIN_OFFLOAD_ELEMENTS` dropped), over a forward of the
   repeated block on the `meta` device: shapes only, no memory. The JAX
   package flattens the block's `jax.vjp` closure under `eval_shape`.
2. `analytic_bytes_per_token_per_layer` / `offloaded_bytes_per_step`: the
   llm-analysis-style estimate of Table 4, element size from the torch
   dtype.
3. `project(system)`: the Fig. 9 projection on the paper's A100 and
   4x D7-P5810 arithmetic: forward time from the achieved model FLOP/s,
   t_step = 6ND / (rate x GPUs), PCIe write rate = offloaded bytes /
   (t_step / 2), lifespan = endurance bytes x t_step / bytes a step.
   `project_device_lifespans` is the same per drive of a striped array,
   from its measured per-device bytes. No number here is a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (RunSettings, apply_block,
                                            build_segments, init_block,
                                            layer)
from repro_torch.core.tree import tree_flatten, tree_unflatten

# paper §3.3.2 / Algorithm 2 line 12: tensors < 2^20 elements stay on GPU
MIN_OFFLOAD_ELEMENTS = 2 ** 20


def _meta_block_params(seg, cfg: ModelConfig):
    """One layer's parameters of segment `seg` as meta tensors: the init
    runs under FakeTensorMode for its shapes, nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dtype = dtype_of(cfg.dtype)
    with FakeTensorMode():
        fake = {f"b{i}": init_block(torch.Generator(), b, cfg, dtype, 1)
                for i, b in enumerate(seg.blocks)}
    leaves, tdef = tree_flatten(fake)
    return layer(tree_unflatten(tdef, [
        torch.empty(t.shape, dtype=t.dtype, device="meta")
        for t in leaves]), 0)


def residual_bytes_per_layer(cfg: ModelConfig, batch: int, seq: int, *,
                             offloadable_only: bool = True,
                             attn_impl: str = "cuda") -> int:
    """Activation bytes one layer saves for backward, as the staged
    engine's pack hook keeps them for a layer stage of the repeated
    (last) segment, divided by its block count as the JAX package
    divides (a llama-3.2-vision period's stage with its cross block's
    encoder input on the meta device too). `attn_impl` is the run's
    (`"cuda"`: the kernels' autograd Functions, which save their inputs
    only; `"torch"`: the plain paths). offloadable_only drops tensors
    under MIN_OFFLOAD_ELEMENTS, which the spool keeps on the device.

    On `meta` every storage's pointer is 0, so identity is the storage
    object's (held alive with the tensor), never its address."""
    seg = build_segments(cfg)[-1]
    settings = RunSettings(attn_impl=attn_impl, attn_chunk=256,
                           param_dtype=cfg.dtype, device="meta")
    params = _meta_block_params(seg, cfg)
    x = torch.empty((batch, seq, cfg.d_model), dtype=dtype_of(cfg.dtype),
                    device="meta", requires_grad=True)
    # a vision model's cross blocks read the image patch embeddings, an
    # input of the stage the engine excludes as it excludes x (and, the
    # chain ending at vlm_enc, without requires_grad)
    enc = (torch.empty((batch, cfg.encoder_seq_len, cfg.d_model),
                       dtype=dtype_of(cfg.dtype), device="meta")
           if any(b.mixer == "cross" for b in seg.blocks) else None)
    inputs = [x] if enc is None else [x, enc]
    excluded = {id(t.untyped_storage())
                for t in tree_flatten(params)[0] + inputs}
    saved: Dict[tuple, torch.Tensor] = {}

    def pack(t):
        st = t.untyped_storage()
        if id(st) not in excluded:
            saved.setdefault((id(st), t.storage_offset(), tuple(t.shape),
                              t.stride(), t.dtype), t)
        return t

    leaves, tdef = tree_flatten(params)
    p = tree_unflatten(tdef, [t.requires_grad_(True) for t in leaves])
    positions = torch.arange(seq, device="meta") if cfg.use_rope else None
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = x
        for i, bdef in enumerate(seg.blocks):
            h, _ = apply_block(bdef, p[f"b{i}"], h, cfg, settings,
                               positions=positions, enc_kv=enc)
    total = sum(t.numel() * t.element_size() for t in saved.values()
                if not offloadable_only
                or t.numel() >= MIN_OFFLOAD_ELEMENTS)
    n_blocks = len(seg.blocks)
    return total // n_blocks if n_blocks > 1 else total


def analytic_bytes_per_token_per_layer(cfg: ModelConfig, *,
                                       tp: int = 1) -> float:
    """llm-analysis-style analytic count of activation bytes per token per
    layer under FlashAttention + tensor parallelism `tp` (the estimator
    the paper extends in §3.4; validated against its Table 4).

    Saved per attention sublayer: block input x (h), norm output (h),
    q/k/v ((Hq+2Hkv)*hd / tp), attention output o (Hq*hd / tp).
    Per MLP sublayer: x (h), norm output (h), hidden pre-activation
    (F/tp), activation output (F/tp), plus the gate branch for GLU MLPs.
    SSM/RG-LRU blocks: projections and scan output at their inner width.
    """
    h = cfg.d_model
    e = dtype_of(cfg.dtype).itemsize
    elems = 0.0
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * h
        # z/x projections (2*d_inner), conv out (d_inner + 2N), scan out
        elems += 2 * d_inner + (d_inner + 2 * cfg.ssm_state_dim) + d_inner
        elems += 2 * h                     # x + gated-norm input
        return elems * e
    # attention (or rg-lru) sublayer
    if cfg.hybrid_pattern:
        # average over the pattern
        n_attn = sum(1 for k in cfg.hybrid_pattern if k == "attn")
        n_rg = len(cfg.hybrid_pattern) - n_attn
        W = cfg.rglru_width or h
        rg_elems = 2 * h + (3 * W + 2 * W) / tp   # gate,in,conv + gates
        hd = cfg.resolved_head_dim
        at_elems = 2 * h + ((cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                            + cfg.num_heads * hd) / tp
        elems += (n_attn * at_elems + n_rg * rg_elems) \
            / len(cfg.hybrid_pattern)
    else:
        hd = cfg.resolved_head_dim
        elems += 2 * h + ((cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                          + cfg.num_heads * hd) / tp
    # mlp sublayer
    if cfg.moe_num_experts:
        # top-k expert FFs touch each token (dropless view)
        F = cfg.d_ff * cfg.moe_top_k
    else:
        F = cfg.d_ff
    if F:
        n_branches = 3 if cfg.mlp_glu else 2
        elems += 2 * h + n_branches * F / tp
    return elems * e


def offloaded_bytes_per_step(cfg: ModelConfig, batch: int, seq: int, *,
                             tp: int = 1) -> int:
    """Whole-model offload traffic per training step per TP shard
    (Table 4 model estimate; the paper measures one of two TP=2 GPUs)."""
    per_tok_layer = analytic_bytes_per_token_per_layer(cfg, tp=tp)
    return int(per_tok_layer * batch * seq * cfg.num_layers)


# ------------------------------------------------------------- Fig. 9
#
# A copy of the JAX package's tables and arithmetic (the port imports
# nothing of it): the paper's A100 and its 4x D7-P5810 array per GPU.

@dataclass(frozen=True)
class GpuSpec:
    name: str = "A100-PCIe"
    peak_flops: float = 312e12        # fp16
    hbm_bw: float = 1.9e12            # bytes/s (A100-40GB PCIe ~1.55-2.0)


@dataclass(frozen=True)
class SsdSpec:
    """4x Solidigm D7-P5810 1.6TB per GPU (paper §3.4)."""
    name: str = "4x D7-P5810"
    endurance_pbw: float = 146.0 * 4  # PB writes across the 4 drives
    jesd_waf: float = 2.5             # sequential writes vs JESD rating
    our_waf: float = 1.0


@dataclass(frozen=True)
class SystemConfig:
    """One Fig. 9 x-axis entry (Megatron-LM table [77])."""
    label: str
    n_params: float
    n_gpus: int
    hidden: int
    layers: int
    seq_len: int
    global_batch: int                 # sequences
    achieved_flops_per_gpu: float     # measured model FLOP/s per GPU [77]
    zero3: bool = False


# Megatron-LM's published scaling table (Narayanan et al. '21), the
# source the paper cites for Fig. 9's system configurations.
MEGATRON_SYSTEMS: List[SystemConfig] = [
    SystemConfig("22B Megatron", 22e9, 64, 6144, 48, 2048, 1536, 149e12),
    SystemConfig("175B Megatron", 175e9, 384, 12288, 96, 2048, 1536,
                 153e12),
    SystemConfig("530B Megatron", 530e9, 1120, 20480, 105, 2048, 2520,
                 159e12),
    SystemConfig("1T Megatron", 1008e9, 3072, 25600, 128, 2048, 3072,
                 163e12),
    SystemConfig("20B ZeRO3", 20e9, 64, 6144, 44, 2048, 1024, 120e12,
                 zero3=True),
    SystemConfig("100B ZeRO3", 100e9, 384, 10240, 80, 2048, 1024, 110e12,
                 zero3=True),
]


@dataclass
class Projection:
    label: str
    t_step_s: float
    act_bytes_per_gpu: float
    pcie_write_gb_s: float
    lifespan_years: float
    max_act_bytes_per_gpu: float


def _act_bytes_per_token_per_layer(hidden: int, dtype_bytes: int = 2,
                                   multiplier: float = 10.6) -> float:
    """Fig. 9's GPT geometry: ~10.6*h elements per token per layer
    survive for backward under FlashAttention."""
    return multiplier * hidden * dtype_bytes


def project(sys: SystemConfig, gpu: GpuSpec = GpuSpec(),
            ssd: SsdSpec = SsdSpec()) -> Projection:
    tokens = sys.global_batch * sys.seq_len
    # model FLOPs per step (6ND); step time from achieved per-GPU rate
    flops = 6.0 * sys.n_params * tokens
    t_step = flops / (sys.achieved_flops_per_gpu * sys.n_gpus)

    act_per_token_layer = _act_bytes_per_token_per_layer(sys.hidden)
    act_total = act_per_token_layer * sys.layers * tokens
    act_per_gpu = act_total / sys.n_gpus

    # §3.4: write window is half the step (adaptive offloading defers the
    # tail of the writes into early backward)
    pcie_write = act_per_gpu / (t_step / 2.0)

    endurance_bytes = (ssd.endurance_pbw * 1e15
                       * ssd.jesd_waf / ssd.our_waf)
    lifespan_s = endurance_bytes * t_step / act_per_gpu
    years = lifespan_s / (365.25 * 24 * 3600)

    # max activations a step could offload: two layers resident, rest on
    # SSD, bounded by SSD capacity per GPU (4 x 1.6 TB)
    max_act = min(4 * 1.6e12, act_per_gpu * 8)
    return Projection(sys.label, t_step, act_per_gpu, pcie_write / 1e9,
                      years, max_act)


def project_all() -> List[Projection]:
    return [project(s) for s in MEGATRON_SYSTEMS]


# -------------------------------------------- per-device wear (io/backends)

@dataclass(frozen=True)
class DeviceWear:
    """Measured write load and projected lifespan of one SSD in a
    striped array (`io.backends.StripedBackend`'s per-device bytes)."""
    device: str
    bytes_written: int
    share: float                  # fraction of the array's total writes
    write_gb_s: float             # sustained rate over the measured window
    lifespan_years: float


def project_device_lifespans(per_device_bytes: Sequence[int],
                             elapsed_s: float, *,
                             ssd: SsdSpec = SsdSpec(),
                             devices_in_spec: int = 4,
                             labels: Optional[Sequence[str]] = None) \
        -> List[DeviceWear]:
    """Fig. 9's lifespan projection, per physical drive: each stripe
    directory stands in for one SSD, so the spec's array endurance over
    `devices_in_spec` is one drive's budget, and its lifespan is that
    budget over the drive's measured write rate (a skewed stripe layout
    shows as one drive aging faster than the rest)."""
    if elapsed_s <= 0:
        raise ValueError("elapsed_s must be positive")
    endurance_per_dev = (ssd.endurance_pbw * 1e15 / devices_in_spec
                         * ssd.jesd_waf / ssd.our_waf)
    total = sum(per_device_bytes)
    out = []
    for i, nbytes in enumerate(per_device_bytes):
        label = labels[i] if labels else f"dev{i}"
        rate = nbytes / elapsed_s
        life_s = endurance_per_dev / rate if rate > 0 else float("inf")
        out.append(DeviceWear(
            device=label, bytes_written=int(nbytes),
            share=(nbytes / total if total else 0.0),
            write_gb_s=rate / 1e9,
            lifespan_years=life_s / (365.25 * 24 * 3600)))
    return out
