"""Registry mapping --arch ids to ModelConfigs, and the assigned 40-cell
(arch x shape) grid with its documented skips: a copy of the JAX
package's `repro/configs/registry.py` over the port's copies of the
config files."""
from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why an (arch x shape) cell is skipped, or None if runnable:
    encoder-only archs have no decode step; long_500k needs sub-quadratic
    attention end to end."""
    if shape.kind == "decode" and not cfg.has_decode:
        return "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "full-attention arch: 524k decode requires sub-quadratic blocks"
    return None


def grid() -> List[Tuple[str, str, Optional[str]]]:
    """All 40 assigned cells as (arch, shape, skip_reason_or_None)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((arch, shape.name, cell_skip_reason(cfg, shape)))
    return out
