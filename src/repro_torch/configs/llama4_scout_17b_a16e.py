"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

NOTE: 40 query heads do not divide the 16-way model axis; the sharding rules
fall back to row-parallel attention projections for this arch (the JAX
package's repro/parallel/sharding.py).

Copied from the JAX package's `repro/configs/llama4_scout_17b_a16e.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                   # per-expert FF width
    vocab_size=202048,
    moe_num_experts=16,
    moe_top_k=1,
    moe_shared_experts=1,
    act="silu",
).validate()
