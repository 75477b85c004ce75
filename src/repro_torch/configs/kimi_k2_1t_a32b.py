"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2 (paper-table)]

Copied from the JAX package's `repro/configs/kimi_k2_1t_a32b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                   # per-expert FF width
    vocab_size=163840,
    moe_num_experts=384,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_first_dense_layers=1,    # leading dense layer (DeepSeek/Kimi style)
    moe_dense_ff=18432,
    act="silu",
).validate()
