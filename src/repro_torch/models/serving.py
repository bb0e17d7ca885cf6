"""LM serving: batched prefill, then a KV-cache greedy decode loop.

The port of ``repro/models/serving.py``. It runs eagerly (JAX jits the
decode step); the prompt and every generated token stay on the params'
device, so the loop never waits on the host between steps. For ``ssm`` and
``hybrid`` the prefill's cache is zeroed (as JAX's), so ``generate``
replays the prompt through decode steps to build the state, as JAX's
does: one decode step a prompt token.

Precision flags: the library sets none. The card checks (``chip_smoke.py``)
run with ``torch.backends.cuda.matmul.allow_tf32``,
``matmul.allow_bf16_reduced_precision_reduction`` and
``cudnn.allow_tf32`` all False, and repeat the prefill-logits comparison
of kernel G against its plain version under torch's defaults. Of those
defaults only ``allow_bf16_reduced_precision_reduction = True`` touches
this path: cuBLAS may then reduce the bf16 projections, MLP and logits
GEMMs in reduced precision, so logits move by bf16 rounding
(``PERF.md`` §6 gives the measured distance). TF32 does not apply (the
fp32 matmuls of the global layers' attention stay in full fp32 by
default) and nothing here calls cuDNN.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import model as M

Tensor = torch.Tensor


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None
                      ) -> Callable:
    def prefill_step(params, batch: Dict[str, Tensor]):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, cache = M.prefill(cfg, params, batch["tokens"],
                                  max_len=max_len, **extras)
        return logits[:, -1:], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, cache, tokens: Tensor, cache_index: int):
        return M.decode_step(cfg, params, cache, tokens, cache_index)
    return step


def generate(cfg: ModelConfig, params, prompt, n_tokens: int,
             max_len: Optional[int] = None, **extras
             ) -> Tuple[Tensor, Tensor]:
    """Greedy generation on the params' device. prompt (B, S) ->
    (tokens (B, n_tokens), prefill logits (B, S, V))."""
    M.check_ported(cfg)
    prompt = torch.as_tensor(prompt, device=params["embed"].device).long()
    b, s = prompt.shape
    max_len = max_len or (s + n_tokens)
    logits, cache = M.prefill(cfg, params, prompt, max_len=max_len, **extras)
    tok = logits[:, -1:].argmax(-1)
    decode = make_decode_step(cfg)
    if cfg.family in ("ssm", "hybrid"):
        # state caches start empty: replay the prompt through decode steps
        # (O(1) per token) so the state reflects the prefix
        cache = M.init_cache(cfg, b, max_len, device=prompt.device)
        for t in range(s):
            lg, cache = decode(params, cache, prompt[:, t:t + 1], t)
        tok = lg.argmax(-1)
    outs = [tok]
    for idx in range(s, s + n_tokens - 1):
        lg, cache = decode(params, cache, tok, idx)
        tok = lg.argmax(-1)
        outs.append(tok)
    return torch.cat(outs, dim=1), logits
