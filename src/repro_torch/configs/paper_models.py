"""The paper's GPT (§4.1) at its published geometry (hidden 8192..16384,
head_dim 128) plus the small CPU-runnable variant, copied from the JAX
package's `repro/configs/paper_models.py`."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def gpt(hidden: int, layers: int, vocab: int = 50304) -> ModelConfig:
    return ModelConfig(
        name=f"gpt-h{hidden}-l{layers}",
        family="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=hidden // 128,
        num_kv_heads=hidden // 128,
        head_dim=128,
        d_ff=4 * hidden,
        vocab_size=vocab,
        act="gelu",
        mlp_glu=False,
    ).validate()


# The paper's three (hidden, layers) scenarios per model (§4.2, Fig. 10).
PAPER_SCENARIOS = [(8192, 4), (12288, 3), (16384, 2)]


def small_gpt(hidden: int = 256, layers: int = 4) -> ModelConfig:
    h = max(2, hidden // 64)
    return dataclasses.replace(gpt(hidden, layers, vocab=2048),
                               num_heads=h, num_kv_heads=h, head_dim=64)
