"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def list_shapes() -> List[str]:
    return list(INPUT_SHAPES)
