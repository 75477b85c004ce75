"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-*-Vision]

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings of shape (batch, encoder_seq_len, d_model).

Copied from the JAX package's `repro/configs/llama_3_2_vision_90b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_period=5,         # every 5th layer cross-attends to patches
    encoder_seq_len=1024,
    act="silu",
).validate()
