"""mamba2-130m [ssm] — 24L d768 attn-free SSD, ssm_state=128 vocab=50280.
[arXiv:2405.21060; unverified]

The numbers are copied from ``repro/configs/mamba2_130m.py``. Every layer
is the Mamba-2 mixer of ``models/ssm.py`` (plain PyTorch: the JAX package
runs no Pallas kernel on this path)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, d_ff=0,
        vocab_size=50280, head_dim=64,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=256, head_dim=16,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=8,
        tie_embeddings=True, dtype="float32")
