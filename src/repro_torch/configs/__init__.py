"""Config registry of the port: the JAX package's arch ids, of which the
decoder-only ones are ported (the dense gemma2-2b, qwen1.5-0.5b,
codeqwen1.5-7b and starcoder2-3b, the MoE grok-1-314b and arctic-480b,
the SSM mamba2-130m and the hybrid zamba2-1.2b); whisper-base and
phi-3-vision-4.2b raise and name their ROADMAP items (13.4, 13.5)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (SHAPES, ModelConfig, ShapeCell, cell_is_runnable,
                   shape_by_name)

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
}
# the ROADMAP Queue 1 item of each arch still to port
_ITEM = {"whisper-base": "13.4", "phi-3-vision-4.2b": "13.5"}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    if arch not in _PORTED:
        raise ValueError(f"arch {arch!r} is not ported yet (ROADMAP Queue 1 "
                         f"item {_ITEM[arch]}); ported: {sorted(_PORTED)}")
    return importlib.import_module(f".{_PORTED[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


__all__ = ["ARCH_IDS", "ModelConfig", "SHAPES", "ShapeCell",
           "cell_is_runnable", "get_config", "get_smoke_config",
           "shape_by_name"]
