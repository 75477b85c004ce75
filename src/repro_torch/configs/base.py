"""Config schema of the PyTorch port: `ModelConfig`, copied field for
field from the JAX package's `repro/configs/base.py`, and the spool's
storage selection trimmed to the fields the serve path reads.

The port keeps its own copy (it imports nothing under `repro.`), so the
two schemas must be kept in step by hand; the port's tests build both
from the same arguments and compare.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "encdec")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads

    # --- attention ---
    causal: bool = True                    # False for encoder-only
    qkv_bias: bool = False
    sliding_window: int = 0                # 0 -> full attention
    # layer i is local (sliding window) iff local_global_period > 0 and
    # i % local_global_period != local_global_period - 1
    local_global_period: int = 0
    attn_logit_softcap: float = 0.0        # 0 -> disabled
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    use_rope: bool = True

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_first_dense_layers: int = 0
    moe_dense_ff: int = 0

    # --- SSM (mamba2 / SSD) ---
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma) ---
    hybrid_pattern: Tuple[str, ...] = ()
    rglru_width: int = 0                   # 0 -> d_model
    rglru_conv_width: int = 4

    # --- cross attention (vlm / encdec decoder) ---
    cross_attn_period: int = 0
    encoder_seq_len: int = 0

    # --- encoder-decoder ---
    num_decoder_layers: int = 0

    # --- input modality ---
    input_kind: str = "tokens"

    # --- misc ---
    act: str = "silu"                      # silu | gelu
    mlp_glu: bool = True                   # gated MLP (False: classic 2-layer)
    max_position: int = 32768              # learned-pos table (non-RoPE archs)
    scale_embed: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    post_block_norm: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the JAX package's
        sharding rule, kept so both packages share one table shape)."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode step."""
        return self.causal

    def validate(self) -> "ModelConfig":
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm":
            if self.num_heads < 1:
                raise ValueError("num_heads must be >= 1")
            if self.num_kv_heads and self.num_heads % self.num_kv_heads:
                raise ValueError("num_heads must be a multiple of "
                                 "num_kv_heads")
        return self


@dataclass(frozen=True)
class SpoolIoConfig:
    """Storage selection of the activation spool, trimmed to what the
    serve path uses. backend: "fs" (one blob file per key in
    `directory`, a fresh temp dir when None) or "mem" (host RAM)."""
    backend: str = "fs"
    directory: Optional[str] = None
    codec: str = "raw"                     # raw | zlib | byteplane
    store_threads: int = 4
    load_threads: int = 4

    def validate(self) -> "SpoolIoConfig":
        if self.backend not in ("fs", "mem"):
            raise ValueError(f"backend {self.backend!r} is not ported "
                             "yet (fs | mem)")
        if self.store_threads < 1 or self.load_threads < 1:
            raise ValueError("spool needs at least one store and one "
                             "load thread")
        return self
