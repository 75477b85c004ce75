"""granite-8b [dense] — llama-arch code model. [arXiv:2405.04324]
Copied from the JAX package's `repro/configs/granite_8b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    act="silu",
).validate()
