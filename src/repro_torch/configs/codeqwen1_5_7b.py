"""codeqwen1.5-7b [dense] — 32L d4096 32H (kv=32) d_ff=13440 vocab=92416,
qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B; hf]

The numbers are copied from ``repro/configs/codeqwen1_5_7b.py``. No layer
is local, so every layer takes the global attention path
(``models.attention.attention``); the LM head is untied."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
        vocab_size=92416, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, qkv_bias=True, dtype="float32")
