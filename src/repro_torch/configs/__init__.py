"""Model configurations of the PyTorch port."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SpoolIoConfig
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.paper_models import (PAPER_SCENARIOS,
                                              SMALL_SCENARIOS, bert, gpt,
                                              small_bert, small_gpt,
                                              small_t5, t5)
from repro_torch.configs.recurrentgemma_9b import \
    CONFIG as RECURRENTGEMMA_9B

__all__ = ["ModelConfig", "SpoolIoConfig", "PAPER_SCENARIOS",
           "SMALL_SCENARIOS", "bert", "gpt", "small_bert", "small_gpt",
           "small_t5", "t5", "resolve_config", "MAMBA2_2_7B",
           "RECURRENTGEMMA_9B"]

# registry ids the port carries so far (the JAX package's
# `configs/registry.py` has more; they wait for their slices)
_REGISTRY = {"mamba2-2.7b": MAMBA2_2_7B,
             "recurrentgemma-9b": RECURRENTGEMMA_9B}


def resolve_config(name: str) -> ModelConfig:
    """Arch string -> ModelConfig: small-gpt, small-bert, gpt-124m,
    gpt-h<H>-l<L> or a registry id the port carries (mamba2-2.7b,
    recurrentgemma-9b); the subset of the JAX package's
    `session.resolve_config` that the port supports so far. BERT and T5 at
    paper width have no string there either: callers build `bert(h, l)`
    and `t5(h, l)`."""
    if name == "gpt-124m":
        return dataclasses.replace(
            gpt(768, 12, vocab=32768), num_heads=12, num_kv_heads=12,
            head_dim=64)
    if name == "small-gpt":
        return small_gpt()
    if name == "small-bert":
        return small_bert()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("gpt-h") and "-l" in name:
        h, l = name[5:].split("-l")
        return gpt(int(h), int(l))
    raise ValueError(f"unknown arch {name!r} (the port knows small-gpt, "
                     f"small-bert, gpt-124m, gpt-h<H>-l<L> and "
                     f"{sorted(_REGISTRY)})")
