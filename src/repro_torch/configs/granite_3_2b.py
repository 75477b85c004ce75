"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]
Copied from the JAX package's `repro/configs/granite_3_2b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,            # padded to 49408 for the 16-way model axis
    act="silu",
    tie_embeddings=True,
).validate()
