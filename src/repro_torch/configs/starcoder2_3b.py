"""starcoder2-3b [dense] — 30L d3072 24H (GQA kv=2) d_ff=12288 vocab=49152,
GQA + RoPE, LayerNorm + GELU. [arXiv:2402.19173; hf]

The numbers are copied from ``repro/configs/starcoder2_3b.py``. The 3b
config is full-attention, so every layer takes the global attention path
(``models.attention.attention``); LayerNorm with bias and the ungated
tanh-GELU MLP."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
        vocab_size=49152, head_dim=128, norm="ln", act="gelu",
        rope_theta=1_000_000.0, tie_embeddings=True,
        mlp_gated=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, norm="ln", act="gelu",
        tie_embeddings=True, mlp_gated=False, dtype="float32")
