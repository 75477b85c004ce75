"""Config schema of the PyTorch port: `ModelConfig`, copied field for
field from the JAX package's `repro/configs/base.py`, and the spool's
storage selection `SpoolIoConfig`.

The port keeps its own copy (it imports nothing under `repro.`), so the
two schemas must be kept in step by hand; the port's tests build both
from the same arguments and compare.
"""
from __future__ import annotations

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

    `host_offload`, `opt_overlap` and `dedupe_replicas` belong to the
    jit engine, the optimizer overlap and meshes (ROADMAP §1 items 9 and
    12) and refuse anything but their defaults."""
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
            (self.host_offload == "none", "host_offload is the jit "
             "engine's, not ported yet (ROADMAP §1 item 9)"),
            (not self.opt_overlap, "opt_overlap is not ported yet "
             "(ROADMAP §1 item 9)"),
            (self.dedupe_replicas, "dedupe_replicas=False is a mesh "
             "option, not ported yet (ROADMAP §1 item 12)"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self
