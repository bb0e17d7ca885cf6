"""gemma2-2b [dense] — 26L d2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local/global alternating (window 4096), attn softcap 50, final logit
softcap 30, sandwich norms, GeGLU. [arXiv:2408.00118; hf]

The numbers are copied from ``repro/configs/gemma2_2b.py``. Its local
layers run the sliding-window attention of kernel G
(``repro_torch/kernels/csrc/window_attn.cu``)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
        vocab_size=256000, head_dim=256, act="gelu",
        local_global=True, window=4096, attn_softcap=50.0,
        logit_softcap=30.0, post_norms=True, scale_embed=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, act="gelu",
        local_global=True, window=8, attn_softcap=50.0, logit_softcap=30.0,
        post_norms=True, scale_embed=True, tie_embeddings=True,
        dtype="float32")
