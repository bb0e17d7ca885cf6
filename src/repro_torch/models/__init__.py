"""The LM side of the port: layers, attention, the decoder-only dense
model (gemma2-2b) and greedy serving. Local attention layers run kernel G
(``repro_torch/kernels/csrc/window_attn.cu``)."""

from . import attention, layers, model, serving
from .model import (decode_step, forward, init_cache, init_params, prefill)
from .serving import generate

__all__ = ["attention", "decode_step", "forward", "generate", "init_cache",
           "init_params", "layers", "model", "prefill", "serving"]
