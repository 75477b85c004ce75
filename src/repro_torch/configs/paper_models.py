"""The paper's evaluation set (§4.1): BERT (encoder-only), GPT
(decoder-only) and T5 (encoder-decoder), at their published geometry
(hidden 8192..16384, head_dim 128) plus the small CPU-runnable variants,
copied from the JAX package's `repro/configs/paper_models.py`."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def bert(hidden: int, layers: int, vocab: int = 30592) -> ModelConfig:
    return ModelConfig(
        name=f"bert-h{hidden}-l{layers}",
        family="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=hidden // 128,
        num_kv_heads=hidden // 128,
        head_dim=128,
        d_ff=4 * hidden,
        vocab_size=vocab,
        causal=False,
        use_rope=False,
        act="gelu",
        mlp_glu=False,
    ).validate()


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


def t5(hidden: int, layers: int, vocab: int = 32128) -> ModelConfig:
    # "For T5, the number of decoders is half of the total number of layers,
    # rounded down." (§4.1)
    return ModelConfig(
        name=f"t5-h{hidden}-l{layers}",
        family="encdec",
        num_layers=layers - layers // 2,   # encoder layers
        num_decoder_layers=layers // 2,
        d_model=hidden,
        num_heads=hidden // 128,
        num_kv_heads=hidden // 128,
        head_dim=128,
        d_ff=4 * hidden,
        vocab_size=vocab,
        encoder_seq_len=0,
        act="gelu",
        use_rope=False,
    ).validate()


# The paper's three (hidden, layers) scenarios per model (§4.2, Fig. 10).
PAPER_SCENARIOS = [(8192, 4), (12288, 3), (16384, 2)]

# CPU-runnable variants of the same families for the benchmarks' defaults.
SMALL_SCENARIOS = [(256, 4), (384, 3), (512, 2)]


def _shrink_heads(c: ModelConfig, hidden: int) -> ModelConfig:
    h = max(2, hidden // 64)
    return dataclasses.replace(c, num_heads=h, num_kv_heads=h, head_dim=64)


def small_bert(hidden: int = 256, layers: int = 4) -> ModelConfig:
    return _shrink_heads(bert(hidden, layers, vocab=2048), hidden)


def small_gpt(hidden: int = 256, layers: int = 4) -> ModelConfig:
    return _shrink_heads(gpt(hidden, layers, vocab=2048), hidden)


def small_t5(hidden: int = 256, layers: int = 4) -> ModelConfig:
    return _shrink_heads(t5(hidden, layers, vocab=2048), hidden)
