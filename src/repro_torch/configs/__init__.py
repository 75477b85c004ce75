"""Model configurations of the port: the JAX package's registry ids
(`registry.py`, over copies of its config files), the paper's models,
and `resolve_config`, the `--arch` strings of both packages."""
import dataclasses

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      SpoolIoConfig, reduced)
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.paper_models import (PAPER_SCENARIOS,
                                              SMALL_SCENARIOS, bert, gpt,
                                              small_bert, small_gpt,
                                              small_t5, t5)
from repro_torch.configs.recurrentgemma_9b import \
    CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.registry import (ARCH_IDS, cell_skip_reason,
                                          get_config, get_shape, grid)

__all__ = ["ModelConfig", "ShapeConfig", "SpoolIoConfig", "SHAPES",
           "reduced", "ARCH_IDS", "get_config", "get_shape", "grid",
           "cell_skip_reason", "PAPER_SCENARIOS", "SMALL_SCENARIOS", "bert",
           "gpt", "small_bert", "small_gpt", "small_t5", "t5",
           "resolve_config", "MAMBA2_2_7B", "RECURRENTGEMMA_9B"]


def resolve_config(name: str) -> ModelConfig:
    """Arch string -> ModelConfig, as the JAX package's
    `session.resolve_config`: a registry id, '<id>:reduced', gpt-124m,
    small-gpt, small-bert or gpt-h<H>-l<L>. BERT and T5 at paper width
    have no string there either: callers build `bert(h, l)` and
    `t5(h, l)`."""
    if name == "gpt-124m":
        return dataclasses.replace(
            gpt(768, 12, vocab=32768), num_heads=12, num_kv_heads=12,
            head_dim=64)
    if name == "small-gpt":
        return small_gpt()
    if name == "small-bert":
        return small_bert()
    if name.endswith(":reduced") and name[:-len(":reduced")] in ARCH_IDS:
        return reduced(get_config(name[:-len(":reduced")]))
    if name in ARCH_IDS:
        return get_config(name)
    if name.startswith("gpt-h") and "-l" in name:
        h, l = name[5:].split("-l")
        return gpt(int(h), int(l))
    raise ValueError(f"unknown arch {name!r} (known: small-gpt, "
                     f"small-bert, gpt-124m, gpt-h<H>-l<L>, a registry id "
                     f"{ARCH_IDS} or '<id>:reduced')")
