"""qwen1.5-0.5b [dense] — 24L d1024 16H (kv=16) d_ff=2816 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

The numbers are copied from ``repro/configs/qwen1_5_0_5b.py``. No layer
is local, so every layer takes the global attention path
(``models.attention.attention``)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
        vocab_size=151936, head_dim=64, qkv_bias=True,
        tie_embeddings=True,
        pure_dp=True,   # 0.5B on a 16-wide TP axis: pure DP wins (§Perf)
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, qkv_bias=True, tie_embeddings=True,
        dtype="float32")
