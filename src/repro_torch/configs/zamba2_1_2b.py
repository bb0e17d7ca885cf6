"""zamba2-1.2b [hybrid] — 38L d2048 Mamba2 backbone + shared attn block
(32H kv=32, d_ff=8192), ssm_state=64 vocab=32000. [arXiv:2411.15242; hf]

Simplification vs. the public checkpoint (DESIGN.md §4): one shared
attn+MLP block applied after every 6th mamba layer (the real model
interleaves two shared blocks with per-invocation LoRA deltas).

The numbers are copied from ``repro/configs/zamba2_1_2b.py``."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32000, head_dim=64,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, hybrid_attn_every=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, hybrid_attn_every=2,
        ssm_chunk=8, dtype="float32")
