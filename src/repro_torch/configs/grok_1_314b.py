"""grok-1-314b [moe] — 64L d6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

The numbers are copied from ``repro/configs/grok_1_314b.py``. Every layer's
MLP is the top-2 mixture of experts of ``models/moe.py``, whose dispatch
scan runs kernel A (``repro_torch/kernels/csrc/prefix_sum.cu``)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
        vocab_size=131072, head_dim=128,
        n_experts=8, top_k=2,
        moment_dtype="bfloat16",   # HBM budget at 314B (DESIGN.md §5)
        dryrun_microbatches=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, n_experts=4, top_k=2,
        dtype="float32")
