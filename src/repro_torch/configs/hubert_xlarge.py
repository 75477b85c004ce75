"""hubert-xlarge [audio] — encoder-only transformer backbone (w2v2-style).
[arXiv:2106.07447]

The audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings of shape (batch, seq, d_model). Encoder-only:
no decode shapes (decode_32k / long_500k are skipped).

Copied from the JAX package's `repro/configs/hubert_xlarge.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,                # encoder-only, bidirectional
    use_rope=False,              # learned/conv positions in the stub frontend
    input_kind="embeddings",
    act="gelu",
    mlp_glu=False,
).validate()
