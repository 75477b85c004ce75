"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-*]
Copied from the JAX package's `repro/configs/qwen2_5_3b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=True,
).validate()
