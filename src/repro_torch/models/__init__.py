"""The LM side of the port: layers, attention, the mixture of experts,
the Mamba-2 block, the decoder-only models (dense, MoE, SSM, hybrid) and
greedy serving. Local attention layers run kernel G
(``repro_torch/kernels/csrc/window_attn.cu``); the MoE dispatch runs
kernel A (``repro_torch/kernels/csrc/prefix_sum.cu``). Whisper and the
VLM prefix wait for ROADMAP Queue 1 items 13.4 and 13.5."""

from . import attention, layers, model, moe, serving, ssm
from .model import (decode_step, forward, init_cache, init_params, prefill)
from .serving import generate

__all__ = ["attention", "decode_step", "forward", "generate", "init_cache",
           "init_params", "layers", "model", "moe", "prefill", "serving",
           "ssm"]
