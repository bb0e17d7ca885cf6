"""Deprecated shim (port of ``repro.train.serve``): the LM prefill/decode
helpers live in ``repro_torch.models.serving`` since the particle serving
tier (``repro_torch.serve``) took the "serve" name. This module re-exports
them for compatibility."""

from ..models.serving import (generate, make_decode_step,  # noqa: F401
                              make_prefill_step)

__all__ = ["generate", "make_decode_step", "make_prefill_step"]
