"""Config schema of the PyTorch port: `ModelConfig`, copied field for
field from the JAX package's `repro/configs/base.py`, the spool's
storage selection `SpoolIoConfig`, and the registry's input shapes
(`ShapeConfig`, `SHAPES`) and tiny same-family configs (`reduced`).

The port keeps its own copy (it imports nothing under `repro.`), so the
two schemas must be kept in step by hand; the port's tests build both
from the same arguments and compare.
"""
from __future__ import annotations

import dataclasses
import math
import mmap
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

    @property
    def supports_long_context(self) -> bool:
        """Every block is sub-quadratic (SSM, linear recurrence, or
        windowed attention in a hybrid): full-attention archs skip
        long_500k."""
        if self.family == "ssm":
            return True
        if self.hybrid_pattern:
            return self.sliding_window > 0
        return False

    def validate(self) -> "ModelConfig":
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm":
            if self.num_heads < 1:
                raise ValueError("num_heads must be >= 1")
            if self.num_kv_heads and self.num_heads % self.num_kv_heads:
                raise ValueError("num_heads must be a multiple of "
                                 "num_kv_heads")
        if self.moe_num_experts and not (
                0 < self.moe_top_k <= self.moe_num_experts):
            raise ValueError("moe_top_k must be in [1, moe_num_experts]")
        return self


@dataclass(frozen=True)
class SpoolIoConfig:
    """Declarative selection of the activation spool's storage stack
    (`repro_torch.io`), the JAX package's fields and checks.
    `repro_torch.io.build_backend` turns it into a `StorageBackend`.

    backend: "fs" (one directory / one SSD), "striped" (chunks across
    `stripe_dirs`, a multi-SSD array), "mem" (host RAM), "tiered" (RAM
    under `host_mem_budget_bytes`, spilling to a lower fs/striped
    backend), "managed" (the `repro_torch.cache.CacheManager`: class- and
    reuse-distance-aware placement over a host-RAM bound
    `host_mem_budget_bytes` and an SSD tier picked by `cache_ssd`, with
    background promotion of up to `cache_promote_depth` blobs per hint
    and failing-SSD fallback), "aio" (O_DIRECT from pooled aligned
    buffers with `queue_depth` segments; buffered + fdatasync where the
    filesystem refuses O_DIRECT), or a full spec string of
    `repro_torch.io.factory` ("fault@2:striped:/a,/b").

    The data-plane knobs apply to every backend: `alignment` and
    `pool_bytes` (the idle cap; on the card raised to the most bytes
    leased at once) size the shared aligned buffer pool that loads,
    stores and aio writes stage through. `retry_*` bound the
    spool workers' retries of transient I/O errors; `on_fetch_fail` says
    what the engine does when a fetch fails for good. `bandwidth_limit`
    (encoded bytes/s) throttles every store and load, to simulate a
    slower tier.

    `host_offload` is what the jit engine routes through the spool:
    "none", "opt_state" (the optimizer state staged between steps) or
    "activations" (the layers' residuals); `opt_overlap` turns on the
    optimizer overlap (eager per-layer updates, moments on the spool).
    `dedupe_replicas` (meshes): the primary replica of a replica group
    stores one copy of a layer's saved tensors for the group (False:
    every rank stores its own, `core/hooks.py`)."""
    backend: str = "fs"
    directory: Optional[str] = None        # None -> fresh temp dir
    stripe_dirs: Tuple[str, ...] = ()
    stripe_chunk_bytes: int = 4 << 20
    codec: str = "raw"                     # raw | zlib | byteplane
    host_mem_budget_bytes: int = 256 << 20
    store_threads: int = 4
    load_threads: int = 4
    bandwidth_limit: Optional[float] = None
    host_offload: str = "none"
    opt_overlap: bool = False
    dedupe_replicas: bool = True
    # --- data-plane knobs (buffer pool / direct I/O) ---
    alignment: int = 4096           # pool + O_DIRECT alignment
    queue_depth: int = 4            # aio: concurrent segments per blob
    pool_bytes: int = 256 << 20     # idle cap of the aligned pool
    # --- cache-manager knobs (backend == "managed") ---
    cache_ssd: Optional[str] = None  # SSD-tier spec; None -> fs/striped
    cache_promote_depth: int = 2     # promotions per reuse-horizon hint
    # --- resilience knobs (repro_torch.resilience) ---
    retry_attempts: int = 3          # total tries per spool I/O op
    retry_backoff_s: float = 0.01    # first retry delay (doubles per try)
    retry_backoff_max_s: float = 0.25
    on_fetch_fail: str = "recompute"  # recompute | raise

    def validate(self) -> "SpoolIoConfig":
        kind = self.backend.split(":", 1)[0].split("@", 1)[0]
        checks = [
            (kind in ("fs", "striped", "mem", "tiered", "managed", "aio",
                      "fault"), f"unknown spool backend {self.backend!r}"),
            (self.cache_promote_depth >= 0, "cache_promote_depth < 0"),
            (self.stripe_chunk_bytes > 0, "stripe_chunk_bytes <= 0"),
            (self.host_mem_budget_bytes >= 0, "host_mem_budget_bytes < 0"),
            (self.store_threads >= 1 and self.load_threads >= 1,
             "spool needs at least one store and one load thread"),
            (self.alignment > 0
             and (self.alignment & (self.alignment - 1)) == 0,
             f"alignment must be a power of two, got {self.alignment}"),
            (self.alignment <= mmap.PAGESIZE,
             f"alignment {self.alignment} exceeds the page size "
             f"{mmap.PAGESIZE} that mmap-backed pool buffers guarantee"),
            (self.queue_depth >= 1, "queue_depth < 1"),
            (self.pool_bytes >= 0, "pool_bytes < 0"),
            (self.retry_attempts >= 1, "retry_attempts < 1"),
            (self.retry_backoff_s >= 0 and self.retry_backoff_max_s >= 0,
             "negative retry backoff"),
            (self.on_fetch_fail in ("recompute", "raise"),
             f"on_fetch_fail {self.on_fetch_fail!r}: recompute | raise"),
            (self.backend != "striped" or len(self.stripe_dirs) != 1,
             "striping across one directory is just 'fs'"),
            (self.host_offload in ("none", "opt_state", "activations"),
             f"host_offload {self.host_offload!r}: none | opt_state | "
             f"activations"),
            (isinstance(self.opt_overlap, bool),
             f"opt_overlap must be a bool, got {self.opt_overlap!r}"),
            (isinstance(self.dedupe_replicas, bool),
             f"dedupe_replicas must be a bool, got "
             f"{self.dedupe_replicas!r}"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: training or serving geometry."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned shapes (identical across the 10 LM-family archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: int = 0, d_ff: int = 128,
            vocab: int = 512, experts: int = 4) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (the JAX package's
    `reduced`, field for field)."""
    kv = kv_heads or max(1, min(cfg.num_kv_heads, heads)
                         if cfg.num_kv_heads else heads)
    while heads % kv:
        kv -= 1
    updates = dict(
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, d_ff=d_ff, vocab_size=vocab,
        head_dim=d_model // heads,
    )
    if cfg.moe_num_experts:
        updates.update(moe_num_experts=experts,
                       moe_top_k=min(cfg.moe_top_k, experts),
                       moe_shared_experts=min(cfg.moe_shared_experts, 1),
                       moe_first_dense_layers=min(
                           cfg.moe_first_dense_layers, 1),
                       moe_dense_ff=d_ff)
    if cfg.family == "ssm":
        updates.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.rglru_width:
        updates.update(rglru_width=d_model)
    if cfg.sliding_window:
        updates.update(sliding_window=min(cfg.sliding_window, 16))
    if cfg.encoder_seq_len:
        updates.update(encoder_seq_len=16)
    if cfg.num_decoder_layers:
        updates.update(num_decoder_layers=max(1, layers // 2))
    if cfg.cross_attn_period:
        updates.update(cross_attn_period=2)
    return dataclasses.replace(cfg, **updates).validate()
