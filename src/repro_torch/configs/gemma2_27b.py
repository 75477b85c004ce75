"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118]

Copied from the JAX package's `repro/configs/gemma2_27b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    local_global_period=2,       # local, global, local, global, ...
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    post_block_norm=True,
    tie_embeddings=True,
    scale_embed=True,
).validate()
