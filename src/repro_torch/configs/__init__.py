"""Config registry of the port: the JAX package's ten arch ids (the dense
gemma2-2b, qwen1.5-0.5b, codeqwen1.5-7b and starcoder2-3b, the MoE
grok-1-314b and arctic-480b, the SSM mamba2-130m, the hybrid zamba2-1.2b,
the VLM phi-3-vision-4.2b and the encoder-decoder whisper-base), one
module each."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (SHAPES, ModelConfig, ShapeCell, cell_is_runnable,
                   input_specs, shape_by_name)

ARCH_IDS: List[str] = [
    "grok-1-314b", "arctic-480b", "zamba2-1.2b", "mamba2-130m",
    "codeqwen1.5-7b", "starcoder2-3b", "qwen1.5-0.5b", "gemma2-2b",
    "phi-3-vision-4.2b", "whisper-base",
]

_PORTED: Dict[str, str] = {
    "gemma2-2b": "gemma2_2b", "qwen1.5-0.5b": "qwen1_5_0_5b",
    "codeqwen1.5-7b": "codeqwen1_5_7b", "starcoder2-3b": "starcoder2_3b",
    "grok-1-314b": "grok_1_314b", "arctic-480b": "arctic_480b",
    "mamba2-130m": "mamba2_130m", "zamba2-1.2b": "zamba2_1_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b", "whisper-base": "whisper_base",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(f".{_PORTED[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


__all__ = ["ARCH_IDS", "ModelConfig", "SHAPES", "ShapeCell",
           "cell_is_runnable", "get_config", "get_smoke_config",
           "input_specs", "shape_by_name"]
