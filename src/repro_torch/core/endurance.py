"""SSD write amount per training step (paper §3.4, Table 4): the
llm-analysis-style analytic count of activation bytes, ported from the
JAX package's `repro/core/endurance.py` (`analytic_bytes_per_token_per_layer`,
`offloaded_bytes_per_step`), with the element size taken from the torch
dtype instead of `jnp.dtype`.

Not ported yet (ROADMAP §1): the exact counter `residual_bytes_per_layer`
(the JAX package flattens the block's `jax.vjp` closure under
`eval_shape`) and the Fig. 9 projection (`project`, `project_all`).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of


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
