"""arctic-480b [moe] — 35L d7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP. [hf:Snowflake/snowflake-arctic-base; hf]

The numbers are copied from ``repro/configs/arctic_480b.py``. Every layer
adds a dense MLP to its mixture of experts (``moe_dense_residual``); the
experts' dispatch scan runs kernel A."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
        vocab_size=32000, head_dim=128,
        n_experts=128, top_k=2, moe_dense_residual=True,
        moment_dtype="bfloat16",
        dryrun_microbatches=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, head_dim=16, n_experts=8, top_k=2,
        moe_dense_residual=True, dtype="float32")
