"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2
recurrent, copied from the JAX package's
`repro/configs/recurrentgemma_9b.py`. [arXiv:2402.19427 (Griffin)]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,              # MQA on the attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,         # attention blocks are local-only
    hybrid_pattern=("rglru", "rglru", "attn"),
    rglru_width=4096,
    rglru_conv_width=4,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
).validate()
