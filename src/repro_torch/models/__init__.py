"""The LM side of the port: layers, attention, the mixture of experts,
the Mamba-2 block, the models of all ten configs (dense, MoE, SSM,
hybrid, the VLM prefix and whisper's encoder-decoder) and greedy
serving. Local attention layers run kernel G
(``repro_torch/kernels/csrc/window_attn.cu``); the MoE dispatch runs
kernel A (``repro_torch/kernels/csrc/prefix_sum.cu``)."""

from . import attention, layers, model, moe, serving, ssm
from .model import (decode_step, forward, init_cache, init_params, prefill)
from .serving import generate

__all__ = ["attention", "decode_step", "forward", "generate", "init_cache",
           "init_params", "layers", "model", "moe", "prefill", "serving",
           "ssm"]
