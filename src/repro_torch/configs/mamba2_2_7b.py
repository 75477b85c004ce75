"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free, copied
from the JAX package's `repro/configs/mamba2_2_7b.py`. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,             # n_heads = expand * d_model / head_dim = 80
    ssm_chunk=128,
    ssm_conv_width=4,
    use_rope=False,
).validate()
